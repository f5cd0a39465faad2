"""Wrapper of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``).

:func:`flash_attention_fwd` takes the heads-major layout of its TPU
counterpart in ``repro.kernels.flash_attention.flash_attention``, with
its ``q_offset`` and ``sk_valid``; the kernel tiles the sequences itself,
so the lengths need not be multiples of a block, and reads q, k, v and
writes the output through their strides (``ops.flash_attention`` hands
it transposed views of the model's (B, S, H, hd) tensors).  On a CPU
tensor it runs the plain version from ``ref.py``; on a CUDA tensor it
launches the kernel on the current stream or raises (on a dtype it does
not take too: no cast, no plain run).  q, and k and v together, are each
float32 or bfloat16 (``paged_attention.DTYPE_CODES``), independently;
the kernel computes in float32 and the output has q's dtype, as in the
TPU kernel.  Forward only: inputs that require grad are refused.
:data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    DTYPE_CODES, _check, _forward_only, _raise_on, _stream)

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0}

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
_MAX_HD = 128
#: the kernel's tiles (``BQ``, ``BK``, ``STAGES`` in the source): query rows
#: per block, keys per tile, stages of the K/V ring
BLOCK_Q, BLOCK_K, RING_STAGES = 128, 64, 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load((SOURCE,))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = ([i, i] + [p] * 4 + [i] * 10 + [f]
                                           + [ctypes.c_longlong] * 12 + [p])
    lib.flash_attention_launch.restype = i
    return lib


def _chunk(t: torch.Tensor) -> int:
    """Elements of the kernel's row copies of ``t`` (``chunk_elems`` in
    ``kernels/csrc/bf16.cuh``): 16 bytes, or 8 for bf16 rows whose
    head_dim is not a multiple of 8."""
    return 4 if t.element_size() == 4 or t.shape[-1] % 8 else 8


def _strides(t: torch.Tensor):
    """(batch, head, row) strides of a (B, H, S, hd) tensor as the kernel
    reads it (0 for a dimension of size 1), or None unless its last stride
    is 1 and its start and strides are whole copy chunks
    (:func:`_chunk`)."""
    ch = _chunk(t)
    if t.stride(-1) != 1 or t.data_ptr() % (ch * t.element_size()):
        return None
    st = tuple(0 if n == 1 else s
               for n, s in zip(t.shape[:3], t.stride()[:3]))
    return None if any(s % ch for s in st) else st


def _readable(t: torch.Tensor) -> torch.Tensor:
    """t itself if the kernel can read it in place, else an aligned
    contiguous copy."""
    if _strides(t) is not None:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0,
                        sk_valid: int | None = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd), any strides → (B, H, Sq,
    hd) of q's dtype in q's memory layout.  q, and k and v together, are
    each float32 or bfloat16.

    Keys at or past ``sk_valid`` (default: all ``Sk``) are padding and
    never seen; query row i sits at position ``i + q_offset``.  A row
    that sees no key gives 0.  The kernel reads q, k and v in place when
    their last stride is 1 and their rows are aligned to its copies
    (16 bytes; 8 for bf16 rows of a head_dim that is not a multiple of
    8), so a transposed view of a (B, S, H, hd) tensor costs no copy; any
    other input is copied first."""
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
    _check("q", q, DTYPE_CODES, q.device, contiguous=False)
    _check("k", k, DTYPE_CODES, q.device, contiguous=False)
    _check("v", v, (k.dtype,), q.device, contiguous=False)
    if hd % 4 or hd > _MAX_HD:
        raise ValueError(f"head_dim {hd} unsupported: the kernel takes a "
                         f"multiple of 4 up to {_MAX_HD}")
    q, k, v = _readable(q), _readable(k), _readable(v)
    out = torch.empty_like(q)               # q's strides, a fresh buffer
    code = _lib().flash_attention_launch(
        DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, Sq, Sk, hd,
        sk_valid, q_offset, int(causal), window or 0, hd ** -0.5,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        _stream(q.device))
    _raise_on(code, "flash_fwd_kernel")
    LAUNCHES["flash_attention"] += 1
    return out
