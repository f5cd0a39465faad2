"""Attention: GQA with optional sliding window / QKV bias (serving path).

PyTorch counterpart of the main-path half of ``repro.models.attention``:
the projections, the O(S²) oracle, the forward of the chunked
online-softmax attention (with its ``q_offset``, so a prefill chunk can
slide along the sequence), the table helpers and the gather oracle of
paged decode.  The custom backward of ``chunked_attention`` belongs to
the training slice and is not here.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, init_dense

NEG_INF = -1e30


def init_attn(cfg, *, generator: torch.Generator, device,
              dtype=torch.bfloat16) -> dict:
    D, H, KV, HD = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {"norm": torch.ones(D, device=device, dtype=dtype),
         "wq": init_dense(D, H * HD, **kw),
         "wk": init_dense(D, KV * HD, **kw),
         "wv": init_dense(D, KV * HD, **kw),
         "wo": init_dense(H * HD, D, **kw)}
    if cfg.attn.qkv_bias:
        p["bq"] = torch.zeros(H * HD, device=device, dtype=dtype)
        p["bk"] = torch.zeros(KV * HD, device=device, dtype=dtype)
        p["bv"] = torch.zeros(KV * HD, device=device, dtype=dtype)
    return p


def qkv_proj(params: dict, x: torch.Tensor, cfg,
             positions: torch.Tensor | None):
    """x: (B,S,D) → q (B,S,H,hd), k/v (B,S,KV,hd), rope applied."""
    B, S, _ = x.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.attn.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, H, HD)
    k = k.reshape(B, S, KV, HD)
    v = v.reshape(B, S, KV, HD)
    if cfg.attn.rope and positions is not None:
        q = apply_rope(q, positions, cfg.attn.rope_theta)
        k = apply_rope(k, positions, cfg.attn.rope_theta)
    return q, k, v


# ----------------------------------------------------------------- oracle ----
def direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int | None = None,
                     q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd). GQA by head grouping."""
    B, Sq, H, hd = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    G = H // KV
    qf = q.reshape(B, Sq, KV, G, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, hd)


# ----------------------------------------------------- chunked (flash-eager) --
#: queries are processed in blocks of this many rows so the live
#: (B, KV, G, q_block, chunk) score tile stays bounded
Q_BLOCK = 2048


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_offset: int = 0, chunk: int = 256) -> torch.Tensor:
    """Online-softmax attention over KV chunks (forward only)."""
    return chunked_attention_fwd(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, chunk=chunk)


def chunked_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          q_offset=0, chunk: int = 256) -> torch.Tensor:
    """Inference chunked attention; ``q_offset`` shifts the query
    positions (a prefill chunk starting at ``q_offset``)."""
    Sq = q.shape[1]
    qc = Q_BLOCK if (Sq > Q_BLOCK and Sq % Q_BLOCK == 0) else Sq
    if qc == Sq:
        return _chunked_fwd_body(q, k, v, causal, window, q_offset, chunk)
    return torch.cat([
        _chunked_fwd_body(q[:, i:i + qc], k, v, causal, window,
                          q_offset + i, chunk)
        for i in range(0, Sq, qc)], dim=1)


def _chunked_fwd_body(q, k, v, causal, window, q_offset, chunk):
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    n_chunks = -(-Sk // chunk)
    qf = q.reshape(B, Sq, KV, G, hd).float() / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        if kb.shape[1] < chunk:                      # zero-pad the last chunk
            pad = chunk - kb.shape[1]
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb)   # (B,KV,G,Sq,chunk)
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = kpos[None, :] < Sk
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window is not None:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


# --------------------------------------------------------- paged decode ref ----
def assemble_shard_tables(tables: torch.Tensor) -> torch.Tensor:
    """Monolithic ``(W*Bs, M)`` view of a ``(W, Bs, M)`` interleaved shard
    stack (slot ``b`` at shard ``b % W``, row ``b // W``); the identity
    for a 2-D table."""
    if tables.dim() == 2:
        return tables
    W, Bs, M = tables.shape
    return tables.permute(1, 0, 2).reshape(W * Bs, M)


def lookup_slot_blocks(tables: torch.Tensor, slots: torch.Tensor,
                       blk_idx: torch.Tensor) -> torch.Tensor:
    """Physical block of logical block ``blk_idx[i]`` for slot
    ``slots[i]``, for either table layout."""
    if tables.dim() == 2:
        return tables[slots, blk_idx]
    W = tables.shape[0]
    return tables[slots % W, slots // W, blk_idx]


def fuse_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Head-interleave K and V along the head axis (K even, V odd):
    ``(..., KV, hd) × 2 → (..., KV*2, hd)``."""
    return torch.stack([k, v], dim=-2).reshape(
        *k.shape[:-2], 2 * k.shape[-2], k.shape[-1])


def split_fused_kv(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Strided K/V views of a head-interleaved fused array (inverse of
    :func:`fuse_kv`)."""
    return kv[..., 0::2, :], kv[..., 1::2, :]


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor,
                               window: int | None = None) -> torch.Tensor:
    """Decode attention over the FPR paged cache (gather oracle).

    q: (B, H, hd); k_pool/v_pool: (N, bs, KV, hd); block_tables: (B, M)
    int32 (<0 = non-resident); lengths: (B,) tokens in cache including
    the new one; window: sliding-window size or None.
    """
    B, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    M = block_tables.shape[1]
    G = H // KV
    tables = block_tables.clamp(min=0).long()             # clamp holes
    k = k_pool[tables].reshape(B, M * bs, KV, hd).float()
    v = v_pool[tables].reshape(B, M * bs, KV, hd).float()
    qf = q.reshape(B, KV, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k)            # (B,KV,G,S)
    pos = torch.arange(M * bs, device=q.device)[None, :]
    lengths = lengths.to(q.device)
    valid = (pos < lengths[:, None]) & (
        block_tables.repeat_interleave(bs, dim=1) >= 0)
    if window is not None:
        valid &= pos > lengths[:, None] - 1 - window       # SWA
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return out.reshape(B, H, hd).to(q.dtype)
