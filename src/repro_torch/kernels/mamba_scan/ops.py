"""Public selective-scan op: the reference's padding shim over the kernel.

Counterpart of ``repro.kernels.mamba_scan.ops``.
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_fwd


def mamba_scan(dt, A, B, C, x, h0, *, chunk: int = 64):
    """dt, x: (B, S, DI) f32; A: (DI, N); B, C: (B, S, N); h0: (B, DI, N)
    → (y (B, S, DI), h_last).  Matches ``models.mamba``'s sequential
    recurrence.  The sequence is zero-padded to a multiple of ``chunk``
    (at most ``max(8, S)``), as the reference pads for its TPU tiles:
    ``dt = 0`` gives ``exp(0) = 1`` and no input, so the carried state
    passes the padding unchanged."""
    S = dt.shape[1]
    chunk = min(chunk, max(8, S))
    pad = (-S) % chunk
    if pad:
        dt, B, C, x = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B, C, x))
    y, h_last = mamba_scan_fwd(dt.contiguous(), A.contiguous(),
                               B.contiguous(), C.contiguous(),
                               x.contiguous(), h0.contiguous())
    return y[:, :S], h_last


__all__ = ["mamba_scan"]
