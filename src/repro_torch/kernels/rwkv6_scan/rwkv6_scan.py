"""Wrapper of the RWKV-6 WKV CUDA kernel (``csrc/rwkv6_scan.cu``).

:func:`rwkv6_scan_fwd` takes the heads-major layout of its TPU
counterpart in ``repro.kernels.rwkv6_scan.rwkv6_scan``, through strides
(``ops.rwkv6_scan`` hands it token-major views).  On a CPU tensor
it runs the plain version from ``ref.py``; on a CUDA tensor it launches
the kernel on the current stream or raises.  Forward only: inputs that
require grad are refused.  :data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.paged_attention.paged_attention import (
    _check, _forward_only, _raise_on, _stream)
from repro_torch.kernels.rwkv6_scan import ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"rwkv6_scan": 0}

SOURCE = Path(__file__).parent / "csrc" / "rwkv6_scan.cu"
#: head sizes the kernel instantiates
_HEAD_DIMS = (16, 32, 64)
#: blocks per head, each owning hd / col_split value columns of the state
#: (capped at hd / 8: an MMA tile is 8 columns wide)
_COL_SPLIT = 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load((SOURCE,))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv6_scan_launch.argtypes = [p] * 8 + [i] * 5 + [ll] * 6 + [p]
    lib.rwkv6_scan_launch.restype = i
    return lib


def col_split(hd: int) -> int:
    """Blocks per (b, head) the kernel runs at head size ``hd``."""
    return min(_COL_SPLIT, hd // 8)


def _strides(t: torch.Tensor):
    """(b, h, t) strides of a (B, nH, S, hd) tensor as the kernel reads it
    (0 for a dimension of size 1), or None if its rows are not 16-byte
    aligned float4 rows."""
    if t.stride(-1) != 1:
        return None
    st = tuple(0 if n == 1 else s for n, s in zip(t.shape[:3], t.stride()[:3]))
    if any(s % 4 for s in st) or t.data_ptr() % 16:
        return None
    return st


def rwkv6_scan_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor):
    """r, k, v, w: (B, nH, S, hd) f32, any strides; u: (nH, hd); S0:
    (B, nH, hd, hd) → (y (B, nH, S, hd), S_last (B, nH, hd, hd)).

    The kernel reads r, k, v and w through their strides (one set, shared
    by the four), so a token-major tensor seen through ``transpose(1, 2)``
    costs no copy, and y has r's memory layout.  Inputs whose strides
    differ or whose rows are not 16-byte aligned are made contiguous
    first."""
    B, nH, S, hd = r.shape
    if (any(t.shape != r.shape for t in (k, v, w)) or u.shape != (nH, hd)
            or S0.shape != (B, nH, hd, hd)):
        raise ValueError(f"shapes do not match: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}, S0 "
                         f"{tuple(S0.shape)}")
    _forward_only("rwkv6_scan", r, k, v, w, u, S0)
    if r.device.type == "cpu":
        y, s_last = ref.rwkv6_scan_ref(*(t.transpose(1, 2) for t in
                                         (r, k, v, w)), u, S0)
        return y.transpose(1, 2), s_last
    for name, t in (("u", u), ("S0", S0)):
        _check(name, t, (torch.float32,), r.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.device != r.device or t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, the "
                             f"kernel takes torch.float32 on {r.device}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head size {hd} unsupported: the kernel takes "
                         f"{_HEAD_DIMS}")
    st = _strides(r)
    if st is None or any(_strides(t) != st for t in (k, v, w)):
        r, k, v, w = (t.contiguous() for t in (r, k, v, w))
        st = _strides(r)
    y = torch.empty_like(r)
    yst = _strides(y)
    if yst is None:
        y = torch.empty(r.shape, dtype=r.dtype, device=r.device)
        yst = _strides(y)
    s_last = torch.empty_like(S0, memory_format=torch.contiguous_format)
    code = _lib().rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        S0.data_ptr(), y.data_ptr(), s_last.data_ptr(), B, nH, S, hd,
        col_split(hd), *st, *yst, _stream(r.device))
    _raise_on(code, "rwkv6_scan_kernel")
    LAUNCHES["rwkv6_scan"] += 1
    return y, s_last
