"""Plain PyTorch versions of the paged-attention kernels.

``paged_decode_attention_sharded_ref`` reads the ``(W, Bs, M)`` shard
stack through its monolithic view; ``paged_decode_attention_fused_ref``
splits the head-interleaved fused pool (K even, V odd) and defers to it;
``ragged_fused_ref`` is the oracle of the ragged kernel (packed mixed
prefill and decode rows, per-element causal / length / window / hole
mask).  The CUDA kernels in ``csrc/`` are held against these on the
same inputs, and the kernel wrappers run them for tensors on the CPU.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.attention import (NEG_INF, assemble_shard_tables,
                                          paged_decode_attention_ref,
                                          split_fused_kv)


def paged_decode_attention_sharded_ref(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        shard_tables: torch.Tensor, lengths: torch.Tensor,
        window: int | None = None) -> torch.Tensor:
    """Oracle for the shard-native split-pool kernel path."""
    B = q.shape[0]
    tables = assemble_shard_tables(shard_tables)[:B]
    return paged_decode_attention_ref(q, k_pool, v_pool, tables, lengths,
                                      window=window)


def paged_decode_attention_fused_ref(
        q: torch.Tensor, kv_pool: torch.Tensor, shard_tables: torch.Tensor,
        lengths: torch.Tensor, window: int | None = None) -> torch.Tensor:
    """Oracle for the fused-pool kernel path."""
    k_pool, v_pool = split_fused_kv(kv_pool)
    return paged_decode_attention_sharded_ref(q, k_pool, v_pool,
                                              shard_tables, lengths,
                                              window=window)


def ragged_fused_ref(q: torch.Tensor, kv_pool: torch.Tensor,
                     tables: torch.Tensor, token_row: torch.Tensor,
                     token_pos: torch.Tensor, kv_lens: torch.Tensor,
                     window: int | None = None) -> torch.Tensor:
    """Oracle for the ragged fused kernel.

    q: (T, H, hd) packed query rows (padding rows included); kv_pool:
    (N, bs, KV*2, hd); tables: (B, M) or (W, Bs, M); token_row: (T,)
    batch slot per packed token (-1 = padding); token_pos: (T,) global
    position; kv_lens: per-slot kv lengths → (T, H, hd) with padding rows
    zeroed.  Rows are gathered slot by slot, so the live key tensor is
    one slot's window rather than one window per packed token.
    """
    T, H, hd = q.shape
    k_pool, v_pool = split_fused_kv(kv_pool)
    N, bs, KV, _ = k_pool.shape
    G = H // KV
    mono = assemble_shard_tables(tables)                   # (slots, M)
    M = mono.shape[1]
    kpos = torch.arange(M * bs, device=q.device)[None, :]
    out = torch.zeros(T, KV, G, hd, dtype=torch.float32, device=q.device)
    for slot in torch.unique(token_row[token_row >= 0]).tolist():
        rows = (token_row == slot).nonzero()[:, 0]
        tab = mono[slot]                                   # (M,)
        phys = tab.clamp(min=0).long()
        k = k_pool[phys].reshape(M * bs, KV, hd).float()
        v = v_pool[phys].reshape(M * bs, KV, hd).float()
        qf = q[rows].reshape(-1, KV, G, hd).float() / math.sqrt(hd)
        s = torch.einsum("tkgd,skd->tkgs", qf, k)          # (R,KV,G,S)
        qpos = token_pos[rows][:, None]
        valid = (kpos <= qpos) & (kpos < kv_lens[slot]) & (
            tab.repeat_interleave(bs)[None, :] >= 0)
        if window is not None:
            valid &= kpos > qpos - window
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out[rows] = torch.einsum("tkgs,skd->tkgd", p, v)
    return out.reshape(T, H, hd).to(q.dtype)


__all__ = ["paged_decode_attention_ref", "paged_decode_attention_sharded_ref",
           "paged_decode_attention_fused_ref", "ragged_fused_ref",
           "assemble_shard_tables"]
