"""Wrapper of the absorbed-MLA paged decode CUDA kernel
(``csrc/mla_attention.cu``).

:func:`mla_paged_ctx_fwd` takes the layouts of its TPU counterpart in
``repro.kernels.mla_attention.mla_attention``: queries already folded
through W_UK, the latent and rope-key pools, and the ``(W, Bs, M)``
shard stack (slot ``b`` at shard ``b % W``, row ``b // W``).  On a CPU
tensor it runs the plain version from ``ref.py``; on a CUDA tensor it
launches the kernel on the current stream or raises (on a dtype it does
not take too: no cast, no plain run).  The queries and the pools are
each float32 or bfloat16 (``paged_attention.DTYPE_CODES``),
independently; the kernel computes in float32 and the context is
float32, as in the TPU kernel.  The kernel splits
each slot's pages (``split.py``): the wrapper sizes the split count and
the partial-result scratch from shapes alone, and a call is the kernel
and, past one split, its merge.  :data:`LAUNCHES` counts each wrapper
call once.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.mla_attention import ref
from repro_torch.kernels.mla_attention import split as _split
from repro_torch.kernels.paged_attention.paged_attention import (
    DTYPE_CODES, _check, _raise_on, _stream)

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"mla_ctx": 0}

SOURCE = Path(__file__).parent / "csrc" / "mla_attention.cu"
_TILE = 32
_MAX_RANK = 512
_MAX_ROPE = 64
#: heads per CTA: one 16-row MMA tile (fixed in the .cu)
HEADS_PER_CTA = 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load((SOURCE,))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mla_ctx_launch.argtypes = [i, i] + [p] * 9 + [i] * 8 + [f, i, i, p]
    lib.mla_ctx_launch.restype = i
    return lib


def mla_paged_ctx_fwd(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_pool: torch.Tensor, rope_pool: torch.Tensor,
                      tables: torch.Tensor, lengths: torch.Tensor, *,
                      scale: float) -> torch.Tensor:
    """q_lat: (B, H, rank); q_rope: (B, H, rope_hd); c_pool: (N, bs, rank);
    rope_pool: (N, bs, rope_hd); tables: (W, Bs, M) int32 shard stack;
    lengths: (B,) int32 → latent context (B, H, rank) f32.  The queries
    share one dtype and the pools one, each float32 or bfloat16.  A slot
    that sees no token gives 0."""
    B, H, rank = q_lat.shape
    rope = q_rope.shape[-1]
    N, bs, rank_p = c_pool.shape
    if (q_rope.shape[:2] != (B, H) or rank_p != rank
            or rope_pool.shape != (N, bs, rope)):
        raise ValueError(f"shapes do not match: q_lat {tuple(q_lat.shape)}, "
                         f"q_rope {tuple(q_rope.shape)}, c_pool "
                         f"{tuple(c_pool.shape)}, rope_pool "
                         f"{tuple(rope_pool.shape)}")
    if tables.dim() != 3:
        raise ValueError(f"tables must be the (W, Bs, M) shard stack, got "
                         f"shape {tuple(tables.shape)}")
    W, Bs, M = tables.shape
    if W * Bs < B:
        raise ValueError(f"shard stack covers {W * Bs} slots < batch {B}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({B},)")
    if q_lat.device.type == "cpu":
        return ref.mla_paged_ctx_ref(q_lat, q_rope, c_pool, rope_pool,
                                     tables, lengths, scale=scale)
    dev = q_lat.device
    # 16-byte aligned for the pages' bulk copies; q_rope takes q_lat's
    # dtype, rope_pool c_pool's
    _check("q_lat", q_lat, DTYPE_CODES, dev, align=16)
    _check("q_rope", q_rope, (q_lat.dtype,), dev, align=16)
    _check("c_pool", c_pool, DTYPE_CODES, dev, align=16)
    _check("rope_pool", rope_pool, (c_pool.dtype,), dev, align=16)
    _check("tables", tables, (torch.int32,), dev)
    _check("lengths", lengths, (torch.int32,), dev)
    if rank % 8 or rank > _MAX_RANK or rope % 8 or rope > _MAX_ROPE:
        raise ValueError(f"rank {rank} / rope_hd {rope} unsupported: the "
                         f"kernel takes multiples of 8 up to {_MAX_RANK} / "
                         f"{_MAX_ROPE}")
    if bs % _TILE:
        raise ValueError(f"block size {bs} is not a multiple of {_TILE}")
    out = torch.empty(B, H, rank, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    nsplit = _split.num_splits(M * bs, _split.MLA_SPLIT)
    shapes = _split.scratch_shapes(out.shape, nsplit)
    scratch = ([torch.empty(sh, dtype=torch.float32, device=dev)
                for sh in shapes] if shapes else [])
    ptrs = [t.data_ptr() for t in scratch] or [None, None]
    code = _lib().mla_ctx_launch(
        DTYPE_CODES[q_lat.dtype], DTYPE_CODES[c_pool.dtype],
        q_lat.data_ptr(), q_rope.data_ptr(), c_pool.data_ptr(),
        rope_pool.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), *ptrs, B, H, rank, rope, bs, W, Bs, M, scale,
        _split.MLA_SPLIT, nsplit, _stream(dev))
    _raise_on(code, "mla_ctx_kernel")
    LAUNCHES["mla_ctx"] += 1
    return out
