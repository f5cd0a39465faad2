"""Wrappers of the paged-attention CUDA kernels (``csrc/paged_attention.cu``).

Each wrapper takes the layouts of its TPU counterpart in
``repro.kernels.paged_attention.paged_attention``:

  * :func:`paged_attention_fwd` — split ``(N, bs, KV, hd)`` K and V pools;
  * :func:`paged_attention_fused_fwd` — the fused head-interleaved
    ``(N, bs, KV*2, hd)`` pool (K even, V odd), ``buffer_depth`` 1, 2 or 4
    tiles in flight (one kernel covers the unpipelined and the pipelined
    TPU kernels; the depth never changes the output);
  * :func:`ragged_fused_fwd` — packed mixed prefill and decode rows in
    tiles of :data:`QT` query rows.

Tables are the ``(W, Bs, M)`` shard stack (slot ``b`` at shard ``b % W``,
row ``b // W``).  On a CPU tensor a wrapper runs the plain version from
``ref.py``; on a CUDA tensor it launches the kernel on the current stream
or raises.  :data:`LAUNCHES` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.paged_attention import ref

#: query-tile height of the ragged kernel — packed rows are padded so a
#: tile never spans two sequences
QT = 8

#: kernel launches since the last :func:`reset_launches`, per CUDA kernel
LAUNCHES = {"paged_decode": 0, "ragged": 0}

_SOURCES = (Path(__file__).parent / "csrc" / "paged_attention.cu",)
_MAX_HD = 128
_TILE = 32
#: query heads per CTA: decode (G ≤ 8 per block), ragged (QT × 4 warps)
_DECODE_GC = 8
_RAGGED_GC = 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _table_index(b: int, m: int, *, W: int, Bs: int, M: int) -> int:
    """Flattened index of (slot b, logical block m) in the (W, Bs, M)
    shard stack: shard b % W, local row b // W.  W == 1 ⇒ b * M + m."""
    if W == 1:
        return b * M + m
    return (b % W) * (Bs * M) + (b // W) * M + m


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCES)
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    lib.paged_decode_launch.argtypes = [
        i, p, p, p, ll, ll, ll, p, p, p,
        i, i, i, i, i, i, i, i, i, i, f, p]
    lib.paged_decode_launch.restype = i
    lib.ragged_launch.argtypes = [
        p, p, ll, ll, p, p, p, p, p,
        i, i, i, i, i, i, i, i, i, i, f, p]
    lib.ragged_launch.restype = i
    return lib


def _heads_per_cta(G: int, cap: int) -> int:
    """Largest divisor of G that is at most ``cap`` (one warp per head)."""
    return max(d for d in range(1, min(G, cap) + 1) if G % d == 0)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes "
                         f"{dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_geometry(hd: int, bs: int) -> None:
    if hd % 4 or hd > _MAX_HD:
        raise ValueError(f"head_dim {hd} unsupported: the kernel takes a "
                         f"multiple of 4 up to {_MAX_HD}")
    if bs % _TILE:
        raise ValueError(f"block size {bs} is not a multiple of {_TILE}")


def _raise_on(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _decode_launch(q, k_ptr, v_ptr, blk_stride, tok_stride, head_stride,
                   tables, lengths, *, bs, window, depth):
    B, KV, G, hd = q.shape
    W, Bs, M = tables.shape
    gc = _heads_per_cta(G, _DECODE_GC)
    out = torch.empty_like(q)
    if B == 0:
        return out
    code = _lib().paged_decode_launch(
        depth, q.data_ptr(), k_ptr, v_ptr, blk_stride, tok_stride,
        head_stride, tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, KV, G, gc, hd, bs, W, Bs, M, window or 0, hd ** -0.5,
        _stream(q.device))
    _raise_on(code, "paged_decode_kernel")
    LAUNCHES["paged_decode"] += 1
    return out


def _check_decode(q, tables, lengths, hd, bs):
    B = q.shape[0]
    W, Bs, M = tables.shape
    if W * Bs < B:
        raise ValueError(f"shard stack covers {W * Bs} slots < batch {B}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({B},)")
    _check("q", q, torch.float32, q.device)
    _check("tables", tables, torch.int32, q.device)
    _check("lengths", lengths, torch.int32, q.device)
    _check_geometry(hd, bs)


def paged_attention_fwd(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, shard_tables: torch.Tensor,
                        lengths: torch.Tensor, *,
                        window: int | None = None) -> torch.Tensor:
    """q: (B, KV, G, hd); pools: (N, bs, KV, hd); shard_tables: (W, Bs, M)
    int32; lengths: (B,) int32 → (B, KV, G, hd).  Split K/V pools."""
    B, KV, G, hd = q.shape
    N, bs, KVp, hdp = k_pool.shape
    if (KVp, hdp) != (KV, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
                         f" do not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        o = ref.paged_decode_attention_sharded_ref(
            q.reshape(B, KV * G, hd), k_pool, v_pool, shard_tables, lengths,
            window=window)
        return o.reshape(B, KV, G, hd)
    _check_decode(q, shard_tables, lengths, hd, bs)
    _check("k_pool", k_pool, torch.float32, q.device)
    _check("v_pool", v_pool, torch.float32, q.device)
    return _decode_launch(
        q, k_pool.data_ptr(), v_pool.data_ptr(), bs * KV * hd, KV * hd, hd,
        shard_tables, lengths, bs=bs, window=window, depth=1)


def paged_attention_fused_fwd(q: torch.Tensor, kv_pool: torch.Tensor,
                              shard_tables: torch.Tensor,
                              lengths: torch.Tensor, *,
                              window: int | None = None,
                              buffer_depth: int = 1) -> torch.Tensor:
    """q: (B, KV, G, hd); fused pool: (N, bs, KV*2, hd) head-interleaved
    (K even, V odd); shard_tables: (W, Bs, M); lengths: (B,) →
    (B, KV, G, hd).  ``buffer_depth`` (1, 2 or 4) tiles in flight; the
    output is bit-identical at every depth."""
    B, KV, G, hd = q.shape
    N, bs, KV2, hdp = kv_pool.shape
    if KV2 != 2 * KV or hdp != hd:
        raise ValueError(f"fused pool {tuple(kv_pool.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if buffer_depth not in (1, 2, 4):
        raise ValueError(f"buffer_depth must be 1, 2 or 4, got "
                         f"{buffer_depth}")
    if q.device.type == "cpu":
        o = ref.paged_decode_attention_fused_ref(
            q.reshape(B, KV * G, hd), kv_pool, shard_tables, lengths,
            window=window)
        return o.reshape(B, KV, G, hd)
    _check_decode(q, shard_tables, lengths, hd, bs)
    _check("kv_pool", kv_pool, torch.float32, q.device)
    base = kv_pool.data_ptr()
    return _decode_launch(
        q, base, base + hd * kv_pool.element_size(), bs * KV2 * hd,
        KV2 * hd, 2 * hd, shard_tables, lengths, bs=bs, window=window,
        depth=buffer_depth)


def ragged_fused_fwd(q: torch.Tensor, kv_pool: torch.Tensor,
                     shard_tables: torch.Tensor, tile_row: torch.Tensor,
                     tile_pos: torch.Tensor, kv_lens: torch.Tensor, *,
                     window: int | None = None) -> torch.Tensor:
    """Ragged fused-KV attention over packed query rows.

    q: (T, KV, G, hd), T a multiple of :data:`QT`, each row's segment
    padded so tiles never span rows; fused pool: (N, bs, KV*2, hd);
    shard_tables: (W, Bs, M); tile_row: (T // QT,) batch slot per tile
    (-1 = padding tile); tile_pos: (T // QT,) position of each tile's
    first query; kv_lens: (W * Bs,) kv length per slot → (T, KV, G, hd).
    Padding rows come out finite (zeros from the kernel, zeros from the
    plain version); callers drop them.
    """
    T, KV, G, hd = q.shape
    if T % QT:
        raise ValueError(f"packed length {T} not a multiple of QT={QT}")
    N, bs, KV2, hdp = kv_pool.shape
    if KV2 != 2 * KV or hdp != hd:
        raise ValueError(f"fused pool {tuple(kv_pool.shape)} does not match "
                         f"q {tuple(q.shape)}")
    W, Bs, M = shard_tables.shape
    tiles = T // QT
    if tile_row.shape != (tiles,) or tile_pos.shape != (tiles,):
        raise ValueError(f"tile descriptors must be ({tiles},)")
    if kv_lens.shape != (W * Bs,):
        raise ValueError(f"kv_lens shape {tuple(kv_lens.shape)} != "
                         f"({W * Bs},)")
    if q.device.type == "cpu":
        token_row = tile_row.repeat_interleave(QT)
        token_pos = (tile_pos[:, None]
                     + torch.arange(QT, device=q.device)).reshape(-1)
        o = ref.ragged_fused_ref(q.reshape(T, KV * G, hd), kv_pool,
                                 shard_tables, token_row, token_pos,
                                 kv_lens, window=window)
        return o.reshape(T, KV, G, hd)
    for name, t in (("tables", shard_tables), ("tile_row", tile_row),
                    ("tile_pos", tile_pos), ("kv_lens", kv_lens)):
        _check(name, t, torch.int32, q.device)
    _check("q", q, torch.float32, q.device)
    _check("kv_pool", kv_pool, torch.float32, q.device)
    _check_geometry(hd, bs)
    out = torch.empty_like(q)
    if tiles == 0:
        return out
    gc = _heads_per_cta(G, _RAGGED_GC)
    code = _lib().ragged_launch(
        q.data_ptr(), kv_pool.data_ptr(), bs * KV2 * hd, KV2 * hd,
        shard_tables.data_ptr(), tile_row.data_ptr(), tile_pos.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), tiles, KV, G, gc, hd, bs, W, Bs,
        M, window or 0, hd ** -0.5, _stream(q.device))
    _raise_on(code, "ragged_kernel")
    LAUNCHES["ragged"] += 1
    return out
