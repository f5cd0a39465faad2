"""Wrapper of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``).

:func:`flash_attention_fwd` takes the heads-major layout of its TPU
counterpart in ``repro.kernels.flash_attention.flash_attention``, with
its ``q_offset`` and ``sk_valid``; the kernel tiles the sequences itself,
so the lengths need not be multiples of a block.  On a CPU tensor it
runs the plain version from ``ref.py``; on a CUDA tensor it launches the
kernel on the current stream or raises.  Forward only: inputs that
require grad are refused.  :data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    _check, _forward_only, _raise_on, _stream)

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0}

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
_MAX_HD = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load((SOURCE,))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [p] * 4 + [i] * 10 + [f, p]
    lib.flash_attention_launch.restype = i
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0,
                        sk_valid: int | None = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) → (B, H, Sq, hd) f32.

    Keys at or past ``sk_valid`` (default: all ``Sk``) are padding and
    never seen; query row i sits at position ``i + q_offset``.  A row
    that sees no key gives 0."""
    B, H, Sq, hd = q.shape
    _, KV, Sk, _ = k.shape
    if (k.shape != (B, KV, Sk, hd) or v.shape != k.shape or KV == 0
            or H % KV):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    sk_valid = Sk if sk_valid is None else sk_valid
    if not 0 <= sk_valid <= Sk:
        raise ValueError(f"sk_valid {sk_valid} outside [0, {Sk}]")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    _forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        o = ref.flash_attention_ref(
            q.transpose(1, 2), k[:, :, :sk_valid].transpose(1, 2),
            v[:, :, :sk_valid].transpose(1, 2), causal=causal, window=window,
            q_offset=q_offset)
        return o.transpose(1, 2)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, torch.float32, q.device)
        if t.data_ptr() % 16:                # float4 reads
            raise ValueError(f"{name} is not 16-byte aligned")
    if hd % 4 or hd > _MAX_HD:
        raise ValueError(f"head_dim {hd} unsupported: the kernel takes a "
                         f"multiple of 4 up to {_MAX_HD}")
    out = torch.empty_like(q)
    code = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Sk, hd, sk_valid, q_offset, int(causal), window or 0,
        hd ** -0.5, _stream(q.device))
    _raise_on(code, "flash_fwd_kernel")
    LAUNCHES["flash_attention"] += 1
    return out
