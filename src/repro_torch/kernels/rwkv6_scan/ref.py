"""Plain PyTorch version of the RWKV-6 WKV recurrence (re-exported).

``rwkv6_scan_ref(r, k, v, w, u, S0)`` is ``models.rwkv6._wkv_sequential``
(r, k, v, w: (B, S, nH, hd); u: (nH, hd); S0: (B, nH, hd, hd) →
(y, S_last), step by step), the function of
the CUDA kernel in ``csrc/rwkv6_scan.cu`` and of the TPU kernel it
replaces.  The kernel wrapper runs it for tensors on the CPU, and the
kernel is held against it on the card.
"""

from __future__ import annotations

from repro_torch.models.rwkv6 import _wkv_sequential as rwkv6_scan_ref


__all__ = ["rwkv6_scan_ref"]
