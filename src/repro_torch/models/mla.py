"""Multi-head Latent Attention (DeepSeek-V2) — expanded and absorbed forms.

PyTorch counterpart of ``repro.models.mla``.  Prefill uses the *expanded*
form (regular attention after the up-projection); decode uses the
*absorbed* form: queries are folded through W_UK so attention runs
directly against the rank-``kv_lora_rank`` latent cache, which is why MLA
pages are ~9× smaller than GQA pages.  The paged softmax over latents is
the CUDA kernel in ``kernels/mla_attention``; :func:`mla_decode_ref` is
the gather oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import NEG_INF, chunked_attention
from repro_torch.models.layers import apply_rope, init_dense, rms_norm


def init_mla(cfg, *, generator: torch.Generator, device,
             dtype=torch.bfloat16) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk_hd = m.nope_head_dim + m.rope_head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "norm": torch.ones(D, device=device, dtype=dtype),
        "wq_a": init_dense(D, m.q_lora_rank, **kw),
        "q_norm": torch.ones(m.q_lora_rank, device=device, dtype=dtype),
        "wq_b": init_dense(m.q_lora_rank, H * qk_hd, **kw),
        "wkv_a": init_dense(D, m.kv_lora_rank + m.rope_head_dim, **kw),
        "kv_norm": torch.ones(m.kv_lora_rank, device=device, dtype=dtype),
        "wkv_b": init_dense(m.kv_lora_rank,
                            H * (m.nope_head_dim + m.v_head_dim), **kw),
        "wo": init_dense(H * m.v_head_dim, D, **kw),
    }


def _project_q(params, h, cfg, positions, tp=None):
    """Queries (B, S, H, nope) and (B, S, H, rope_hd), rope applied.
    Under ``tp`` ``wq_b`` holds the rank's heads' columns: the normed
    query latent (computed whole) passes ``tp.copy_in`` before it, and
    the queries are those heads'."""
    m = cfg.mla
    B, S, _ = h.shape
    qk_hd = m.nope_head_dim + m.rope_head_dim
    q = rms_norm(h @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    if tp is not None:
        q = tp.copy_in(q)
    q = (q @ params["wq_b"]).reshape(B, S, -1, qk_hd)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.attn.rope_theta)


def latent_kv(params, h, cfg, positions):
    """Compressed latents: c_kv (B, S, rank), k_rope (B, S, 1, rope_hd) —
    exactly what the paged cache stores per token."""
    m = cfg.mla
    c_kv, k_rope = (h @ params["wkv_a"]).split(
        [m.kv_lora_rank, m.rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.attn.rope_theta)
    return c_kv, k_rope


def mla_layer(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg, tp=None) -> torch.Tensor:
    """Expanded-form MLA for prefill (causal attention over up-projected
    per-head keys and values).

    Under ``tp`` (``distributed.parallel.TensorParallel``) the rank
    computes its ``H/|model|`` heads: ``wq_a`` and ``wkv_a`` run whole on
    every rank, the query latent, ``c_kv`` and ``k_rope`` pass
    ``tp.copy_in`` before the rank's head columns of ``wq_b`` and
    ``wkv_b``, ``wo`` is those heads' row block and the partial output
    is summed by ``tp.reduce_product``."""
    m = cfg.mla
    B, S, _ = x.shape
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q_nope, q_rope = _project_q(params, h, cfg, positions, tp)
    c_kv, k_rope = latent_kv(params, h, cfg, positions)
    if tp is not None:
        c_kv, k_rope = tp.copy_in(c_kv), tp.copy_in(k_rope)
    H = q_nope.shape[2]
    kv = (c_kv @ params["wkv_b"]).reshape(B, S, H,
                                          m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.nope_head_dim, m.v_head_dim], dim=-1)
    # per-head q/k with the shared rope key broadcast across heads
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.rope_head_dim)], dim=-1)
    # pad v to the q/k head dim so one attention serves both (zeros)
    qk_hd = m.nope_head_dim + m.rope_head_dim
    o = chunked_attention(q, k, F.pad(v, (0, qk_hd - m.v_head_dim)),
                          causal=True)
    o = o[..., :m.v_head_dim].reshape(B, S, H * m.v_head_dim)
    return x + (o @ params["wo"] if tp is None
                else tp.reduce_product(o, params["wo"]))


def absorbed_weights(params, cfg):
    """Split wkv_b into per-head W_UK (rank→nope) and W_UV (rank→v), of
    every head or (a tensor-parallel rank's ``wkv_b`` columns) of the
    rank's."""
    m = cfg.mla
    w = params["wkv_b"].reshape(m.kv_lora_rank, -1,
                                m.nope_head_dim + m.v_head_dim)
    return w[..., :m.nope_head_dim], w[..., m.nope_head_dim:]


def absorbed_query(params, x, positions, cfg, tp=None):
    """Decode queries in latent space: x (B, D) at ``positions`` (B,) →
    q_lat (B, H, rank) f32 (q_nope folded through W_UK) and q_rope
    (B, H, rope_hd) f32, plus W_UV for the up-projection after.  Under
    ``tp`` the heads are the rank's (:func:`_project_q`)."""
    h = rms_norm(x[:, None, :], params["norm"], cfg.norm_eps)
    q_nope, q_rope = _project_q(params, h, cfg, positions[:, None], tp)
    w_uk, w_uv = absorbed_weights(params, cfg)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_uk.float())
    return q_lat, q_rope[:, 0].float(), w_uv


def mla_out(params, x, ctx, w_uv, tp=None):
    """Latent context (B, H, rank) f32 → x + W_O·(ctx·W_UV); under ``tp``
    the rank's heads against ``wo``'s rows of them, summed over
    ``model`` by ``tp.reduce_product``."""
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv.float())
    o = o.reshape(x.shape[0], -1).to(x.dtype)
    return x + (o @ params["wo"] if tp is None
                else tp.reduce_product(o, params["wo"]))


def mla_decode_ref(params: dict, x: torch.Tensor, positions: torch.Tensor,
                   c_pool: torch.Tensor, rope_pool: torch.Tensor,
                   block_tables: torch.Tensor, lengths: torch.Tensor,
                   cfg) -> torch.Tensor:
    """Absorbed-form decode over the paged latent cache (gather oracle).

    x: (B, D) current-token activations (the pre-norm is applied here);
    c_pool: (N, bs, rank) latent pages; rope_pool: (N, bs, rope_hd);
    block_tables: (B, M) int32 (<0 = hole); lengths: (B,).  A slot that
    sees no token averages the gathered rows, as the reference does.
    """
    m = cfg.mla
    B = x.shape[0]
    q_lat, q_rope, w_uv = absorbed_query(params, x, positions, cfg)
    N, bs, rank = c_pool.shape
    M = block_tables.shape[1]
    tables = block_tables.clamp(min=0).long()
    c = c_pool[tables].reshape(B, M * bs, rank).float()
    kr = rope_pool[tables].reshape(B, M * bs, m.rope_head_dim).float()
    scale = 1.0 / (m.nope_head_dim + m.rope_head_dim) ** 0.5
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c)
         + torch.einsum("bhr,bsr->bhs", q_rope, kr)) * scale
    pos = torch.arange(M * bs, device=x.device)[None, :]
    valid = (pos < lengths.to(x.device)[:, None]) & (
        block_tables.repeat_interleave(bs, dim=1) >= 0)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", p, c)                  # latent ctx
    return mla_out(params, x, ctx, w_uv)
