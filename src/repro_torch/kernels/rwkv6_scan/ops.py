"""Public RWKV-6 WKV op: the reference's token-major layout over the
kernel.

Counterpart of ``repro.kernels.rwkv6_scan.ops``.
"""

from __future__ import annotations

from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_scan_fwd


def rwkv6_scan(r, k, v, w, u, S0, *, chunk: int = 32):
    """r, k, v, w: (B, S, nH, hd) f32; u: (nH, hd); S0: (B, nH, hd, hd)
    → (y (B, S, nH, hd), S_last).  Matches ``models.rwkv6._wkv_sequential``.

    The kernel reads the token-major tensors through their strides and
    handles a sequence that is not a multiple of its chunk itself, so no
    transposed or padded copy is made and y comes back token-major.
    ``chunk`` is the reference's signature: the reference pads to it, and
    its padding (w = 1, r = k = v = 0) adds nothing, so it does not change
    the function."""
    del chunk
    y, s_last = rwkv6_scan_fwd(*(t.transpose(1, 2) for t in (r, k, v, w)),
                               u.contiguous(), S0.contiguous())
    return y.transpose(1, 2), s_last


__all__ = ["rwkv6_scan"]
