"""Attention: GQA with optional sliding window / QKV bias.

PyTorch counterpart of ``repro.models.attention``: the projections,
the O(S²) oracle, the chunked online-softmax attention with the
reference's flash-style backward (:func:`chunked_attention`, an
autograd Function) and its inference form (:func:`chunked_attention_fwd`,
whose ``q_offset`` lets a prefill chunk slide along the sequence), the
table helpers, the gather oracle of paged decode, the full-sequence
residual block :func:`attn_layer` and the encoder-decoder cross
attention (:func:`cross_attn_layer`, :func:`encode_cross_kv`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, init_dense, rms_norm

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
             positions: torch.Tensor | None, tp=None):
    """x: (B,S,D) → q (B,S,H,hd), k/v (B,S,KV,hd), rope applied.

    Under ``tp`` (``distributed.parallel.TensorParallel``; x has passed
    ``tp.copy_in``) q, k, v are those of the rank's query heads ``[q0,
    q0 + Hl)`` (``parallel.block``'s: ``⌈H/|model|⌉`` a rank, the last
    short, some ranks none) and of the KV heads ``[k0, k1)`` they read
    (query head h reads KV head h // G) (:func:`rank_heads`).  ``wq``
    holds the query heads' columns where ``H`` splits evenly over
    ``model``, else it comes whole (``H·hd`` wide); ``wk`` and ``wv`` hold
    the KV heads' columns where ``KV`` splits evenly too, else they come
    whole (``KV·hd`` wide).  A leaf that comes whole passes
    ``tp.copy_in`` before this cuts the rank's heads' columns
    (:func:`_rank_cols`), so each rank returns its part of the gradient
    (the ranks that share a KV head each part of it) and the SUM adds
    them.  The biases come whole and are cut the same way.  Where a
    rank's query heads do not read their KV heads in groups of one size
    (``Hl`` and ``G`` divide neither the other), k and v are repeated to
    one KV head a query head.  A rank with no heads returns q, k, v of
    none (every shape fixed by the mesh), still through the same
    products and collectives as the other ranks."""
    B, S, _ = x.shape
    HD = cfg.head_dim
    w = {n: params[n] for n in ("wq", "wk", "wv")}
    if cfg.attn.qkv_bias:
        w.update((n, params[n]) for n in ("bq", "bk", "bv"))
    nq, nkv, read = cfg.n_heads, cfg.n_kv_heads, None
    if tp is not None:
        q0, nq, k0, k1, read = rank_heads(cfg, tp)
        nkv = k1 - k0
        heads = {"q": (q0, q0 + nq, cfg.n_heads),
                 "k": (k0, k1, cfg.n_kv_heads),
                 "v": (k0, k1, cfg.n_kv_heads)}
        for n in tuple(w):
            w[n] = _rank_cols(tp, w[n], *heads[n[1]], HD)
    q = x @ w["wq"]
    k = x @ w["wk"]
    v = x @ w["wv"]
    if cfg.attn.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = q.reshape(B, S, nq, HD)
    k = k.reshape(B, S, nkv, HD)
    v = v.reshape(B, S, nkv, HD)
    if read is not None:
        k, v = _per_query_head(k, v, read)
    if cfg.attn.rope and positions is not None:
        q = apply_rope(q, positions, cfg.attn.rope_theta)
        k = apply_rope(k, positions, cfg.attn.rope_theta)
    return q, k, v


def rank_heads(cfg, tp) -> tuple:
    """A tensor-parallel rank's heads: (first query head ``q0``, query
    heads ``Hl``, KV heads ``[k0, k1)`` they read, and for each query head
    the index of its KV head among those, or None where the rank's query
    heads read them in groups of one size: ``Hl`` and ``G`` divide one
    another).  The query heads are the rank's block of ``H`` as
    ``tp.block`` splits it (``⌈H/|model|⌉``, the last blocks short, some
    empty); a rank with none has ``Hl = 0`` and an empty KV range."""
    G = cfg.n_heads // cfg.n_kv_heads
    q0, q1 = tp.block(cfg.n_heads)
    Hl = q1 - q0
    if Hl == 0:
        return q0, 0, q0 // G, q0 // G, None
    k0, k1 = q0 // G, (q1 - 1) // G + 1
    read = [(q0 + j) // G - k0 for j in range(Hl)]
    KVl = k1 - k0
    if Hl % KVl == 0 and read == [j // (Hl // KVl) for j in range(Hl)]:
        read = None
    return q0, Hl, k0, k1, read


def _rank_cols(tp, w, h0: int, h1: int, heads: int, hd: int):
    """A projection's (or bias's) columns of heads ``[h0, h1)``: ``w``
    itself where it holds those already (the stored block of a leaf
    whose heads split evenly), else, where it came whole (``heads·hd``
    wide), cut after ``tp.copy_in``."""
    if w.shape[-1] != heads * hd:
        return w
    return tp.copy_in(w)[..., h0 * hd:h1 * hd]


def out_proj(o: torch.Tensor, wo: torch.Tensor, cfg, tp=None):
    """Attention's output projection: o (..., heads, hd) → (..., D).
    Under ``tp`` o holds the rank's query heads and meets ``wo``'s rows
    of them (its stored block, or cut from a whole ``wo`` by
    ``tp.cut``), the partial products summed over ``model`` by
    ``tp.reduce_product`` (a rank with no heads adds 0)."""
    o = o.flatten(-2)
    if tp is None:
        return o @ wo
    if wo.shape[0] == cfg.n_heads * cfg.head_dim:         # came whole
        wo = tp.cut(wo, 0, cfg.head_dim)
    return tp.reduce_product(o, wo)


def _per_query_head(k, v, read):
    """k, v repeated to one KV head a query head (``read``)."""
    idx = torch.tensor(read, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def serving_qkv(params: dict, x: torch.Tensor, cfg,
                positions: torch.Tensor | None, tp):
    """Serving under ``tp``: x (B, S, D) → q, k, v of the rank's heads as
    :func:`qkv_proj` gives them (``wq`` its stored block, or whole and
    cut to the rank's heads), and the fused K/V of *every* KV head
    (B, S, 2·KV, hd, :func:`fuse_kv`) for the paged cache, whose pools
    split the sequence over ``model``, never the KV heads.  Where ``wk``
    and ``wv`` come whole (``KV`` does not split over ``model``), k and
    v are computed whole and the rank's KV heads cut from them; where
    they are the rank's KV heads' columns, each rank's fused rows are
    all-gathered over ``model`` (``tp.gather``).  No gradient flows
    through it."""
    B, S, _ = x.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q0, Hl, k0, k1, read = rank_heads(cfg, tp)
    bias = cfg.attn.qkv_bias

    def proj(name, h0, h1, heads, rope=True):
        w = _rank_cols(tp, params[name], h0, h1, heads, HD)
        t = x @ w
        if bias:
            t = t + params["b" + name[1]][h0 * HD:h1 * HD]
        t = t.reshape(B, S, w.shape[-1] // HD, HD)
        if rope and cfg.attn.rope and positions is not None:
            t = apply_rope(t, positions, cfg.attn.rope_theta)
        return t

    q = proj("wq", q0, q0 + Hl, H)
    if params["wk"].shape[-1] == KV * HD:                     # came whole
        k, v = proj("wk", 0, KV, KV), proj("wv", 0, KV, KV, rope=False)
        kv = fuse_kv(k, v)
        k, v = k[:, :, k0:k1], v[:, :, k0:k1]
    else:
        k, v = proj("wk", k0, k1, KV), proj("wv", k0, k1, KV, rope=False)
        kv = tp.gather(fuse_kv(k, v), 2)
    if read is not None:
        k, v = _per_query_head(k, v, read)
    return q, k, v, kv


# ----------------------------------------------------------------- oracle ----
def direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int | None = None,
                     q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd). GQA by head grouping."""
    B, Sq, H, hd = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    G = _groups(H, KV)
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
#: (B, KV, G, q_block, chunk) score tile stays bounded, in both directions
Q_BLOCK = 2048


def _groups(H: int, KV: int) -> int:
    """Query heads a KV head: ``H // KV``, and 1 for a tensor-parallel
    rank with no heads (``H = KV = 0``), whose attention is of empty
    tensors."""
    return H // KV if KV else 1


def _q_blocks(Sq: int) -> int:
    return Q_BLOCK if (Sq > Q_BLOCK and Sq % Q_BLOCK == 0) else Sq


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_offset: int = 0, chunk: int = 256) -> torch.Tensor:
    """Online-softmax attention over KV chunks with a flash-style
    backward: the gradient recomputes each chunk's probabilities from
    (q, k, v, out, lse) instead of keeping every chunk's (B, KV, G, Sq,
    chunk) tile, so both directions live in O(S·chunk) memory."""
    return _ChunkedAttention.apply(q, k, v, causal, window, q_offset,
                                   chunk)[0]


def chunked_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          q_offset=0, chunk: int = 256) -> torch.Tensor:
    """Inference chunked attention; ``q_offset`` (an int or a scalar
    tensor) shifts the query positions (a prefill chunk starting at
    ``q_offset``)."""
    return _chunked_fwd(q, k, v, causal, window, q_offset, chunk)[0]


class _ChunkedAttention(torch.autograd.Function):
    """The reference's ``_chunked_attention_vjp``: forward
    :func:`_chunked_fwd`, backward :func:`_chunked_bwd`; lse is saved,
    never differentiated."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset, chunk):
        return _chunked_fwd(q, k, v, causal, window, q_offset, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset, chunk = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, chunk)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        dq, dk, dv = _chunked_bwd(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def _chunk_mask(qpos, kpos, Sk, causal, window):
    mask = kpos[None, :] < Sk
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return mask


def _kv_chunk(t: torch.Tensor, ci: int, chunk: int) -> torch.Tensor:
    """Keys or values of chunk ``ci`` in f32, the last chunk zero-padded."""
    tb = t[:, ci * chunk:(ci + 1) * chunk].float()
    if tb.shape[1] < chunk:
        tb = torch.nn.functional.pad(tb, (0, 0, 0, 0, 0, chunk - tb.shape[1]))
    return tb


def _chunked_fwd(q, k, v, causal, window, q_offset, chunk):
    """Forward online softmax over KV chunks → (out (B, Sq, H, hd), lse
    (B, KV, G, Sq) f32); queries in Q_BLOCK-row blocks."""
    Sq = q.shape[1]
    qc = _q_blocks(Sq)
    if qc == Sq:
        return _chunked_fwd_body(q, k, v, causal, window, q_offset, chunk)
    outs, lses = zip(*(
        _chunked_fwd_body(q[:, i:i + qc], k, v, causal, window,
                          q_offset + i, chunk) for i in range(0, Sq, qc)))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _chunked_fwd_body(q, k, v, causal, window, q_offset, chunk):
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = _groups(H, KV)
    qf = q.reshape(B, Sq, KV, G, hd).float() / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for ci in range(-(-Sk // chunk)):
        kb, vb = _kv_chunk(k, ci, chunk), _kv_chunk(v, ci, chunk)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb)   # (B,KV,G,Sq,chunk)
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.where(_chunk_mask(qpos, kpos, Sk, causal, window), s,
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out.to(q.dtype), lse


def _chunked_bwd(causal, window, q_offset, chunk, res, dout):
    """The reference's ``_chunked_bwd``: query blocks of Q_BLOCK rows,
    dk and dv summed across them in f32."""
    q, k, v, out, lse = res
    Sq = q.shape[1]
    qc = _q_blocks(Sq)
    if qc == Sq:
        return _chunked_bwd_body(causal, window, q_offset, chunk, res, dout)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dqs = []
    for i in range(0, Sq, qc):
        rows = slice(i, i + qc)
        dqi, dki, dvi = _chunked_bwd_body(
            causal, window, q_offset, chunk,
            (q[:, rows], k, v, out[:, rows], lse[..., rows]), dout[:, rows],
            q_base=i)
        dk = dk + dki.float()
        dv = dv + dvi.float()
        dqs.append(dqi)
    return torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype)


def _chunked_bwd_body(causal, window, q_offset, chunk, res, dout, q_base=0):
    """Per KV chunk: p from the saved lse, ``delta = Σ dO·O`` (the softmax
    backward's diagonal term), then that chunk's dq, dk and dv."""
    q, k, v, out, lse = res
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = _groups(H, KV)
    scale = hd ** -0.5
    qf = q.reshape(B, Sq, KV, G, hd).float()
    dof = dout.reshape(B, Sq, KV, G, hd).float()
    of = out.reshape(B, Sq, KV, G, hd).float()
    qpos = torch.arange(Sq, device=q.device) + (q_offset + q_base)
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B,KV,G,Sq,1)
    dq = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for ci in range(-(-Sk // chunk)):
        kb, vb = _kv_chunk(k, ci, chunk), _kv_chunk(v, ci, chunk)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb) * scale
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = _chunk_mask(qpos, kpos, Sk, causal, window)
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vb)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bkgqs,bskd->bqkgd", ds, kb)
        dks.append(torch.einsum("bkgqs,bqkgd->bskd", ds, qf))
        dvs.append(torch.einsum("bkgqs,bqkgd->bskd", p, dof))
    dk = torch.cat(dks, dim=1)[:, :Sk]
    dv = torch.cat(dvs, dim=1)[:, :Sk]
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


# ------------------------------------------------------------ full layers ----
#: attention over a full sequence: the O(S²) oracle, the chunked online
#: softmax, or the flash-attention CUDA kernel (its plain version on the CPU)
IMPLS = ("direct", "chunked", "kernel")


def attn_layer(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg,
               *, impl: str = "chunked", tp=None,
               causal: bool = True) -> torch.Tensor:
    """Pre-norm residual attention block over (B, S, D): causal (within
    the config's window), or with ``causal=False`` over every position
    and no window (whisper's encoder, whose ``positions`` are None: no
    rope).  With ``tp`` (``distributed.parallel.TensorParallel``) the rank
    computes its block of query heads and the KV heads they read
    (:func:`qkv_proj`) and ``wo``'s rows of its heads (:func:`out_proj`):
    the normed input passes ``tp.copy_in``, the partial output is summed
    by ``tp.reduce_product``."""
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    if tp is not None:
        h = tp.copy_in(h)
    q, k, v = qkv_proj(params, h, cfg, positions, tp)
    w = cfg.attn.window if causal else None
    if impl == "direct":
        o = direct_attention(q, k, v, causal=causal, window=w)
    elif impl == "chunked":
        o = chunked_attention(q, k, v, causal=causal, window=w)
    elif impl == "kernel":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        o = fa_ops.flash_attention(q, k, v, causal=causal, window=w)
    else:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return x + out_proj(o, params["wo"], cfg, tp)


def cross_attn_layer(params: dict, x: torch.Tensor, enc_kv: tuple, cfg,
                     tp=None) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper) over precomputed encoder
    keys and values: pre-norm residual, non-causal, no rope.  With ``tp``
    the rank computes its block of query heads (``wq``'s stored block, or
    whole and cut: :func:`_rank_cols`) against the KV heads they read,
    cut from the whole ``enc_kv`` after ``tp.copy_in`` (the cross K/V of
    every KV head, as the decode state holds it), and sums ``wo``'s row
    block over ``model`` (:func:`out_proj`)."""
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    B, S, _ = h.shape
    H, HD = cfg.n_heads, cfg.head_dim
    k, v = enc_kv
    wq, nq = params["wq"], H
    if tp is not None:
        h = tp.copy_in(h)
        q0, nq, k0, k1, read = rank_heads(cfg, tp)
        wq = _rank_cols(tp, wq, q0, q0 + nq, H, HD)
        k, v = (tp.copy_in(t)[:, :, k0:k1] for t in (k, v))
        if read is not None:
            k, v = _per_query_head(k, v, read)
    q = (h @ wq).reshape(B, S, nq, HD)
    o = chunked_attention(q, k, v, causal=False)
    return x + out_proj(o, params["wo"], cfg, tp)


def encode_cross_kv(params: dict, enc_out: torch.Tensor, cfg) -> tuple:
    """enc_out (B, Se, D) → cross-attention keys and values, each
    (B, Se, KV, hd)."""
    B, Se, _ = enc_out.shape
    KV, HD = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ params["wk"]).reshape(B, Se, KV, HD)
    v = (enc_out @ params["wv"]).reshape(B, Se, KV, HD)
    return k, v
