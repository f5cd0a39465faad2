"""Plain PyTorch version of the selective scan (the sequential recurrence).

``mamba_scan_ref`` is the function of the CUDA kernel in
``csrc/mamba_scan.cu`` (and of the TPU kernel it replaces), computed step
by step.  The kernel wrapper runs it for tensors on the CPU, and the
kernel is held against it on the card.
"""

from __future__ import annotations

import torch


def mamba_scan_ref(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """dt, x: (B, S, DI); A: (DI, N); B, C: (B, S, N); h0: (B, DI, N)
    → (y (B, S, DI), h_last (B, DI, N)):
    ``h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t·x_t``, ``y_t = h_t·C_t``."""
    h = h0
    ys = []
    for t in range(dt.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A[None])
        h = dA * h + dt[:, t, :, None] * B[:, t, None, :] * x[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y, h


__all__ = ["mamba_scan_ref"]
