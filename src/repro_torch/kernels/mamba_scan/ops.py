"""Public selective-scan op over the kernel.

Counterpart of ``repro.kernels.mamba_scan.ops``.
"""

from __future__ import annotations

from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_fwd


def mamba_scan(dt, A, B, C, x, h0, *, chunk: int = 64):
    """dt, x: (B, S, DI) f32; A: (DI, N); B, C: (B, S, N); h0: (B, DI, N)
    → (y (B, S, DI), h_last).  Matches ``models.mamba``'s sequential
    recurrence.

    The kernel reads dt, x, B and C through their strides (B and C are
    column views of the model's ``x_proj`` output) and stops at S itself,
    so no padded or contiguous copy is made.  ``chunk`` is the reference's
    signature: the reference pads the sequence to a multiple of it for its
    TPU tiles, with ``dt = 0``, which passes the state through unchanged,
    so it does not change the function."""
    del chunk
    return mamba_scan_fwd(dt, A.contiguous(), B, C, x, h0.contiguous())


__all__ = ["mamba_scan"]
