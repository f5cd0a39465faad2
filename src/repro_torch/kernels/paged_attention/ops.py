"""Public paged-attention ops (decode + ragged over the FPR block tables).

Counterpart of ``repro.kernels.paged_attention.ops``.  Tables come as
the monolithic ``(B, M)`` table (the single-shard stack ``(1, B, M)``)
or the device-native ``(W, Bs, M)`` shard stack; :func:`shard_descriptor`
is the one place that normalizes them.  :func:`build_ragged_descriptor`
is a NumPy copy of the reference's host-side descriptor builder, the
same algorithm, so the engine's token capacity and the descriptors match
the reference exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.paged_attention.paged_attention import (
    QT, paged_attention_fused_fwd, paged_attention_fwd, ragged_fused_fwd)


def shard_descriptor(tables: torch.Tensor):
    """Normalize a block table to ``(stack (W, Bs, M) int32, W, Bs, M)``;
    ``(B, M)`` becomes the single-shard stack ``(1, B, M)``."""
    if tables.dim() == 2:
        B, M = tables.shape
        return tables.to(torch.int32).reshape(1, B, M).contiguous(), 1, B, M
    if tables.dim() != 3:
        raise ValueError(f"block table must be (B, M) or (W, Bs, M), "
                         f"got shape {tuple(tables.shape)}")
    W, Bs, M = tables.shape
    return tables.to(torch.int32).contiguous(), W, Bs, M


def paged_attention(q: torch.Tensor, kv_pool: torch.Tensor,
                    tables: torch.Tensor, lengths: torch.Tensor, *,
                    window: int | None = None,
                    buffer_depth: int = 1) -> torch.Tensor:
    """Fused-KV paged decode.  q: (B, H, hd); kv_pool: (N, bs, KV*2, hd)
    head-interleaved (K even, V odd); tables: (B, M) or (W, Bs, M);
    lengths: (B,) → (B, H, hd).  Output is bit-identical at every
    ``buffer_depth``."""
    B, H, hd = q.shape
    KV = kv_pool.shape[2] // 2
    stack, _, _, _ = shard_descriptor(tables)
    o = paged_attention_fused_fwd(
        q.reshape(B, KV, H // KV, hd).contiguous(), kv_pool, stack,
        lengths.to(torch.int32).contiguous(), window=window,
        buffer_depth=buffer_depth)
    return o.reshape(B, H, hd)


def paged_attention_split(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          lengths: torch.Tensor, *,
                          window: int | None = None) -> torch.Tensor:
    """Split-K/V decode (two pools): the baseline layout the fused pool
    replaced, kept for the fused-vs-split comparison."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    stack, _, _, _ = shard_descriptor(tables)
    o = paged_attention_fwd(
        q.reshape(B, KV, H // KV, hd).contiguous(), k_pool, v_pool, stack,
        lengths.to(torch.int32).contiguous(), window=window)
    return o.reshape(B, H, hd)


def build_ragged_descriptor(slot_ids, q_lens, q_starts, kv_lens, *,
                            num_slots: int, t_cap: int) -> dict:
    """Host-side (NumPy) ragged descriptor for one mixed engine step.

    ``slot_ids[i]`` is the batch slot of active row i, contributing
    ``q_lens[i]`` query tokens starting at global position
    ``q_starts[i]`` with ``kv_lens[i]`` total kv tokens visible after
    its writes land (decode rows: q_len 1, q_start length-1, kv_len
    length).  Rows are packed in order into a ``t_cap``-token buffer,
    each segment padded to a multiple of :data:`QT` so query tiles never
    span rows.

    Returns int32 NumPy arrays: ``cu_q_lens``/``cu_kv_lens`` (rows+1,)
    exclusive prefix sums of the *real* token counts, ``tile_row``/
    ``tile_pos`` (t_cap // QT,) per-tile batch slot (-1 = padding tile)
    and first-query position, ``token_row``/``token_pos`` (t_cap,)
    per-packed-token batch slot (-1 = padding) and global position,
    ``token_src`` (t_cap,) index into the concatenated real-token stream
    (-1 = padding), ``kv_lens`` (num_slots,) per-slot kv lengths and
    ``last_index`` (num_slots,) packed index of each slot's final real
    token (-1 = inactive slot).
    """
    if t_cap % QT:
        raise ValueError(f"t_cap {t_cap} not a multiple of QT={QT}")
    tiles_cap = t_cap // QT
    tile_row = np.full(tiles_cap, -1, np.int32)
    tile_pos = np.zeros(tiles_cap, np.int32)
    token_row = np.full(t_cap, -1, np.int32)
    token_pos = np.zeros(t_cap, np.int32)
    token_src = np.full(t_cap, -1, np.int32)
    kv = np.ones(num_slots, np.int32)        # >=1 keeps padded rows finite
    last_index = np.full(num_slots, -1, np.int32)
    cu_q = [0]
    cu_kv = [0]
    off = 0
    src = 0
    for slot, qn, start, kvn in zip(slot_ids, q_lens, q_starts, kv_lens):
        qn, start, kvn = int(qn), int(start), int(kvn)
        if qn <= 0:
            continue
        padded = -(-qn // QT) * QT
        if off + padded > t_cap:
            raise ValueError(
                f"ragged batch overflows t_cap={t_cap} "
                f"(need {off + padded})")
        for j in range(padded // QT):
            tile_row[off // QT + j] = slot
            tile_pos[off // QT + j] = start + j * QT
        token_row[off:off + qn] = slot
        token_pos[off:off + padded] = start + np.arange(padded)
        token_src[off:off + qn] = src + np.arange(qn)
        kv[slot] = kvn
        last_index[slot] = off + qn - 1
        cu_q.append(cu_q[-1] + qn)
        cu_kv.append(cu_kv[-1] + kvn)
        off += padded
        src += qn
    return {
        "cu_q_lens": np.asarray(cu_q, np.int32),
        "cu_kv_lens": np.asarray(cu_kv, np.int32),
        "tile_row": tile_row,
        "tile_pos": tile_pos,
        "token_row": token_row,
        "token_pos": token_pos,
        "token_src": token_src,
        "kv_lens": kv,
        "last_index": last_index,
    }


def ragged_paged_attention(q: torch.Tensor, kv_pool: torch.Tensor,
                           tables: torch.Tensor, tile_row: torch.Tensor,
                           tile_pos: torch.Tensor, kv_lens: torch.Tensor, *,
                           window: int | None = None) -> torch.Tensor:
    """Ragged fused-KV attention over one packed mixed batch.

    q: (T, H, hd) packed queries (T a multiple of :data:`QT`); kv_pool:
    (N, bs, KV*2, hd); tables: (B, M) or (W, Bs, M); tile_row/tile_pos:
    (T // QT,); kv_lens: per-slot kv lengths → (T, H, hd).  One call
    serves every chunked-prefill AND decode row of an engine step."""
    T, H, hd = q.shape
    KV = kv_pool.shape[2] // 2
    stack, W, Bs, _ = shard_descriptor(tables)
    kv_lens = kv_lens.to(torch.int32)
    if kv_lens.shape[0] < W * Bs:
        kv_lens = torch.nn.functional.pad(
            kv_lens, (0, W * Bs - kv_lens.shape[0]), value=1)
    o = ragged_fused_fwd(q.reshape(T, KV, H // KV, hd).contiguous(),
                         kv_pool, stack, tile_row.to(torch.int32).contiguous(),
                         tile_pos.to(torch.int32).contiguous(),
                         kv_lens.contiguous(), window=window)
    return o.reshape(T, H, hd)


__all__ = ["paged_attention", "paged_attention_split",
           "ragged_paged_attention", "build_ragged_descriptor",
           "shard_descriptor", "QT"]
