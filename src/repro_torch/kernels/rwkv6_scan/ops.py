"""Public RWKV-6 WKV op: the reference's layout and padding shim over the
kernel.

Counterpart of ``repro.kernels.rwkv6_scan.ops``.
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_scan_fwd


def rwkv6_scan(r, k, v, w, u, S0, *, chunk: int = 32):
    """r, k, v, w: (B, S, nH, hd) f32; u: (nH, hd); S0: (B, nH, hd, hd)
    → (y (B, S, nH, hd), S_last).  Matches ``models.rwkv6._wkv_sequential``.
    The kernel takes heads-major (B, nH, S, hd); the sequence is padded to
    a multiple of ``chunk`` (at most ``max(8, S)``) with ``w = 1`` and
    ``r = k = v = 0``, which adds nothing and leaves the state intact."""
    S = r.shape[1]
    chunk = min(chunk, max(8, S))
    pad = (-S) % chunk
    rt, kt, vt, wt = (t.transpose(1, 2) for t in (r, k, v, w))
    if pad:
        rt, kt, vt = (F.pad(t, (0, 0, 0, pad)) for t in (rt, kt, vt))
        wt = F.pad(wt, (0, 0, 0, pad), value=1.0)
    y, s_last = rwkv6_scan_fwd(rt.contiguous(), kt.contiguous(),
                               vt.contiguous(), wt.contiguous(),
                               u.contiguous(), S0.contiguous())
    return y[:, :, :S].transpose(1, 2), s_last


__all__ = ["rwkv6_scan"]
