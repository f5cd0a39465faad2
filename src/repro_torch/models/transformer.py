"""Model assembly for the serving path: init, prefill, chunked prefill,
decode step and the ragged mixed step.

PyTorch counterpart of the attention-only, dense-FFN subset of
``repro.models.transformer``.  The decode state is a dict of tensors:

  kv:      fused K/V (L_attn, N, bs, KV*2, hd) paged GQA cache, head-
           interleaved (K even, V odd)
  tables:  (W, Bs, M) int32 shard stack or (B, M) — FPR block tables
  lengths: (B,) int32

Differences from the reference, all internal: the layer scan is a
Python loop over layers, and the pools are updated **in place** (the
reference returns new arrays) — a full-size pool is too large to copy
per layer.  Writes the reference drops with ``mode="drop"`` (holes,
padding rows, columns past the table) are masked out explicitly: torch
indexing has no drop mode and wraps negative indices.

``page_impl`` picks the decode/ragged attention: ``"kernel"`` (the CUDA
kernels in ``kernels/paged_attention``; their plain versions on the CPU)
or ``"ref"`` (the gather oracle).  MoE, MLA, mamba, rwkv6 and
encoder-decoder models raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_ffn, embed, init_embed,
                                       init_swiglu, rms_norm, unembed)

BLOCK_SIZE = 128   # tokens per physical KV block

PAGE_IMPLS = ("ref", "kernel")

_QUEUE_ITEM = {"moe": "ROADMAP Queue 1 item 6 (models/moe.py)",
               "mla": "ROADMAP Queue 1 item 7 (MLA decode)",
               "mamba": "ROADMAP Queue 1 item 8 (mamba)",
               "rwkv6": "ROADMAP Queue 1 item 8 (rwkv6)",
               "enc_dec": "ROADMAP Queue 1 item 9 (encoder-decoder)",
               "frontend": "ROADMAP Queue 1 item 9 (multimodal frontends)"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for anything outside this port's slice:
    attention mixers with dense FFNs, decoder-only, text-only."""
    for kind in sorted(set(cfg.mixers) - {"attn"}):
        raise NotImplementedError(f"{kind} mixers are not ported yet: "
                                  f"{_QUEUE_ITEM[kind]}")
    if "moe" in cfg.ffns:
        raise NotImplementedError(f"MoE FFNs are not ported yet: "
                                  f"{_QUEUE_ITEM['moe']}")
    if cfg.enc_dec:
        raise NotImplementedError(f"encoder-decoder models are not ported "
                                  f"yet: {_QUEUE_ITEM['enc_dec']}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.frontend} frontends are not ported "
                                  f"yet: {_QUEUE_ITEM['frontend']}")


# ============================================================ initialisation
def _init_layer(cfg: ModelConfig, *, generator, device, dtype) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    ffn = init_swiglu(cfg.d_model, cfg.dense_d_ff or cfg.d_ff, **kw)
    ffn["norm"] = torch.ones(cfg.d_model, device=device, dtype=dtype)
    return {"mix": attn_mod.init_attn(cfg, **kw), "ffn": ffn}


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> dict:
    """Random parameters made directly on ``device`` from ``generator``.

    Same keys as the reference; ``params["body"][j]`` is a list over
    blocks of per-layer dicts (the reference stacks them along axis 0
    for its scan).
    """
    check_supported(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)
    prefix, period = cfg.segmentation()
    params = {"embed": init_embed(cfg.vocab, cfg.d_model, **kw),
              "final_norm": torch.ones(cfg.d_model, device=device,
                                       dtype=dtype)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_embed(cfg.vocab, cfg.d_model, **kw)
    params["prefix"] = [_init_layer(cfg, **kw) for _ in range(prefix)]
    n_blocks = (cfg.n_layers - prefix) // period if period else 0
    params["body"] = [[_init_layer(cfg, **kw) for _ in range(n_blocks)]
                      for _ in range(period)]
    return params


def layer_params(params: dict, cfg: ModelConfig, i: int) -> dict:
    """Parameters of layer ``i`` (prefix layers, then the periodic body)."""
    prefix, period = cfg.segmentation()
    if i < prefix:
        return params["prefix"][i]
    return params["body"][(i - prefix) % period][(i - prefix) // period]


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return sum(param_count(v) for v in params)


def _unembed_table(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


# ============================================================= decode state
def attn_layer_ids(cfg: ModelConfig) -> list[int]:
    return [i for i in range(cfg.n_layers) if cfg.mixers[i] == "attn"]


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               num_blocks: int | None = None, dtype=torch.float32,
               round_to: int = 1) -> dict:
    """Shapes/dtypes of the decode state.  ``num_blocks`` defaults to
    exactly enough blocks for batch×max_len tokens; ``round_to`` rounds
    the pool up so it divides evenly across (batch × sequence) shards."""
    check_supported(cfg)
    bs = BLOCK_SIZE
    M = (max_len + bs - 1) // bs
    N = num_blocks if num_blocks is not None else batch * M
    N = ((N + round_to - 1) // round_to) * round_to
    spec = {"tables": ((batch, M), torch.int32),
            "lengths": ((batch,), torch.int32)}
    n_attn = len(attn_layer_ids(cfg))
    if n_attn:
        spec["kv"] = ((n_attn, N, bs, 2 * cfg.n_kv_heads, cfg.head_dim),
                      dtype)
    return spec


def sp_identity_tables(batch: int, M: int, N: int, batch_shards: int = 1,
                       seq_shards: int = 1, device="cuda") -> torch.Tensor:
    """Global block-table layout of an (batch × seq)-sharded pool; with
    (1, 1) the identity ``b*M + m`` (see the reference for the layout)."""
    Bl = batch // batch_shards
    M_loc = (M + seq_shards - 1) // seq_shards
    Nl = N // (batch_shards * seq_shards)
    if Bl * M_loc > Nl:
        raise ValueError(f"pool too small: need {Bl}x{M_loc} rows per "
                         f"shard, have {Nl}")
    b = torch.arange(batch)[:, None]
    m = torch.arange(M)[None, :]
    di, bl = b // Bl, b % Bl
    s, ml = m // M_loc, m % M_loc
    g = (di * seq_shards + s) * Nl + bl * M_loc + ml
    return g.to(device=device, dtype=torch.int32)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      num_blocks: int | None = None, dtype=torch.float32,
                      tables: torch.Tensor | None = None,
                      lengths: torch.Tensor | None = None,
                      batch_shards: int = 1, seq_shards: int = 1,
                      device="cuda") -> dict:
    spec = cache_spec(cfg, batch, max_len, num_blocks, dtype,
                      round_to=batch_shards * seq_shards)
    st = {k: torch.zeros(sh, dtype=dt, device=device)
          for k, (sh, dt) in spec.items()}
    if tables is not None:
        st["tables"] = tables
    else:
        (_, M), _ = spec["tables"]
        N = spec["kv"][0][1] if "kv" in spec else batch * M
        st["tables"] = sp_identity_tables(batch, M, N, batch_shards,
                                          seq_shards, device)
    if lengths is not None:
        st["lengths"] = lengths
    return st


# ============================================================ cache writes
def _token_targets(tables: torch.Tensor, slots: torch.Tensor,
                   pos: torch.Tensor, bs: int,
                   keep: torch.Tensor | None = None):
    """Where one token per entry lands in a (N, bs, …) pool: the indices
    of the entries whose write lands, and their (block, offset).  Entries
    mapped to a hole (< 0) — or excluded by ``keep`` — are dropped."""
    M = tables.shape[-1]
    blk = pos.long() // bs
    phys = attn_mod.lookup_slot_blocks(tables, slots.long(),
                                       blk.clamp(max=M - 1))
    land = phys >= 0 if keep is None else keep & (phys >= 0)
    rows = land.nonzero()[:, 0]
    return rows, phys[rows].long(), (pos.long() % bs)[rows]


def _scatter_rows(pool: torch.Tensor, targets, new: torch.Tensor) -> None:
    rows, phys, off = targets
    pool[phys, off] = new[rows].to(pool.dtype)


def _write_token_kv(pool, tables, lengths, new, bs):
    """Scatter one token's cache row per slot into the paged pool, in
    place.  pool: (N, bs, ...); new: (B, ...); the position is
    ``lengths``.  Non-resident (<0) table entries drop the write."""
    B = new.shape[0]
    slots = torch.arange(B, device=new.device)
    _scatter_rows(pool, _token_targets(tables, slots, lengths, bs), new)
    return pool


def _write_token_kv_stacked(pool, layer, tables, lengths, new, bs):
    """:func:`_write_token_kv` into layer ``layer`` of a (L, N, bs, …)
    pool, in place."""
    _write_token_kv(pool[layer], tables, lengths, new, bs)
    return pool


def _scatter_blocks(pool: torch.Tensor, tab: torch.Tensor,
                    seq: torch.Tensor) -> None:
    """seq: (R, bs, ...) whole blocks → pool rows ``tab`` (R,); <0
    entries drop.  In place."""
    keep = (tab >= 0).nonzero()[:, 0]
    pool[tab[keep].long()] = seq[keep].to(pool.dtype)


# ================================================================ decode step
def _paged_attn(q, kv_pool, tables, lengths, *, page_impl, window):
    """One decode-attention step over either table layout: ``kv_pool`` is
    the fused ``(N, bs, KV*2, hd)`` pool, ``tables`` the ``(B, M)`` table
    or the ``(W, Bs, M)`` shard stack."""
    if page_impl == "kernel":
        from repro_torch.kernels.paged_attention import autotune
        from repro_torch.kernels.paged_attention import ops as pa_ops
        _, bs, KV2, hd = kv_pool.shape
        tuned = autotune.get_tuning(KV2 // 2, hd, bs)
        return pa_ops.paged_attention(q, kv_pool, tables, lengths,
                                      window=window,
                                      buffer_depth=tuned.buffer_depth)
    if page_impl != "ref":
        raise ValueError(f"page_impl must be one of {PAGE_IMPLS}, "
                         f"got {page_impl!r}")
    B = q.shape[0]
    k_pool, v_pool = attn_mod.split_fused_kv(kv_pool)
    return attn_mod.paged_decode_attention_ref(
        q, k_pool, v_pool, attn_mod.assemble_shard_tables(tables)[:B],
        lengths, window=window)


def decode_step(params, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                *, page_impl: str = "ref"):
    """One decode step: tokens (B,) → (logits (B, V) f32, state).

    ``state['lengths']`` counts tokens already in the cache; the incoming
    token is written at position ``lengths`` and attends to ``lengths+1``
    tokens (itself included).  The pools are updated in place.
    """
    check_supported(cfg)
    B = tokens.shape[0]
    st = dict(state)
    pos = st["lengths"]
    x = embed(tokens, params["embed"])                   # (B, D)
    positions = pos[:, None]
    targets = _token_targets(st["tables"],
                             torch.arange(B, device=tokens.device), pos,
                             BLOCK_SIZE)
    attn_ids = attn_layer_ids(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, cfg, i)
        a = attn_ids.index(i)
        h = rms_norm(x[:, None], lp["mix"]["norm"], cfg.norm_eps)
        q, k, v = attn_mod.qkv_proj(lp["mix"], h, cfg, positions)
        _scatter_rows(st["kv"][a], targets,
                      attn_mod.fuse_kv(k[:, 0], v[:, 0]))
        o = _paged_attn(q[:, 0], st["kv"][a], st["tables"], pos + 1,
                        page_impl=page_impl, window=cfg.attn.window)
        x = x + o.reshape(B, -1) @ lp["mix"]["wo"]
        x = dense_ffn(lp["ffn"], x[:, None], cfg.norm_eps)[:, 0]
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(h[:, None], _unembed_table(params, cfg))[:, 0]
    st["lengths"] = pos + 1
    return logits, st


# ================================================================== prefill
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, state: dict):
    """Process a full prompt, write the KV cache, return (last_logits,
    state).  tokens: (B, S); token t of sequence b lands at
    pool[tables[b, t//bs], t%bs]."""
    check_supported(cfg)
    B, S = tokens.shape
    bs = BLOCK_SIZE
    st = dict(state)
    x = embed(tokens, params["embed"])
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    tables = attn_mod.assemble_shard_tables(st["tables"])[:B]
    M_used = -(-S // bs)
    tab = tables[:, :M_used].reshape(-1)
    attn_ids = attn_layer_ids(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, cfg, i)
        h = rms_norm(x, lp["mix"]["norm"], cfg.norm_eps)
        q, k, v = attn_mod.qkv_proj(lp["mix"], h, cfg, positions)
        o = attn_mod.chunked_attention(q, k, v, causal=True,
                                       window=cfg.attn.window)
        x = x + o.reshape(B, S, -1) @ lp["mix"]["wo"]
        seq = attn_mod.fuse_kv(k, v)
        seq = torch.nn.functional.pad(
            seq, (0, 0, 0, 0, 0, M_used * bs - S))
        _scatter_blocks(st["kv"][attn_ids.index(i)], tab,
                        seq.reshape((B * M_used, bs) + seq.shape[2:]))
        x = dense_ffn(lp["ffn"], x, cfg.norm_eps)
    h = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = unembed(h[:, None], _unembed_table(params, cfg))[:, 0]
    st["lengths"] = torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)
    return logits, st


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                  state: dict, start: int) -> dict:
    """One fixed-shape prefill chunk: tokens (B, C) at positions
    ``start .. start+C-1`` (C a BLOCK_SIZE multiple, ``start``
    block-aligned).

    Each layer scatters the chunk's K/V rows into the pool at the chunk's
    table columns, then attends the full gathered window with
    ``q_offset=start``.  Keys past the causal frontier are garbage pool
    rows that the mask turns into exact zeros (``exp(NEG_INF - m)``
    underflows to 0.0), so every real query row matches :func:`prefill`.
    Returns the state; logits are not computed (the first decode step
    rewrites position S−1 and produces them).
    """
    check_supported(cfg)
    B, C = tokens.shape
    bs = BLOCK_SIZE
    if C % bs:
        raise ValueError(f"chunk length {C} must be a multiple of "
                         f"BLOCK_SIZE={bs}")
    st = dict(state)
    dev = tokens.device
    x = embed(tokens, params["embed"])
    positions = (start + torch.arange(C, device=dev))[None].expand(B, C)
    tables = attn_mod.assemble_shard_tables(st["tables"])[:B]
    M = tables.shape[1]
    Cb = C // bs
    # the chunk's table columns; columns past the table map to -1 (drop)
    cols = start // bs + torch.arange(Cb, device=dev)
    chunk_tab = torch.where(cols[None, :] < M,
                            tables[:, cols.clamp(max=M - 1)],
                            -1).reshape(-1)
    # full-window key rows; unallocated (-1) columns gather arbitrary
    # resident rows past the causal frontier, which the mask zeroes
    window_rows = tables.clamp(min=0).reshape(-1).long()
    attn_ids = attn_layer_ids(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, cfg, i)
        h = rms_norm(x, lp["mix"]["norm"], cfg.norm_eps)
        q, k, v = attn_mod.qkv_proj(lp["mix"], h, cfg, positions)
        kvp = st["kv"][attn_ids.index(i)]
        seq = attn_mod.fuse_kv(k, v)
        _scatter_blocks(kvp, chunk_tab,
                        seq.reshape((B * Cb, bs) + seq.shape[2:]))
        win = kvp[window_rows].reshape((B, M * bs) + kvp.shape[2:])
        kw, vw = attn_mod.split_fused_kv(win)
        o = attn_mod.chunked_attention_fwd(q, kw, vw, causal=True,
                                           window=cfg.attn.window,
                                           q_offset=start)
        x = x + o.reshape(B, C, -1) @ lp["mix"]["wo"]
        x = dense_ffn(lp["ffn"], x, cfg.norm_eps)
    return st


def ragged_step(params, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                token_row: torch.Tensor, token_pos: torch.Tensor,
                tile_row: torch.Tensor, tile_pos: torch.Tensor,
                kv_lens: torch.Tensor, last_index: torch.Tensor, *,
                page_impl: str = "ref"):
    """One ragged engine step: every chunked-prefill and decode row of the
    batch packed into one fixed-shape token stream and one attention call
    per layer.

    tokens/token_row/token_pos: (T,) packed tokens, their batch slots
    (-1 = padding, writes drop) and positions; tile_row/tile_pos:
    (T // QT,) per-query-tile descriptor of the ragged kernel; kv_lens:
    (num_slots,) kv length of each slot after this step's writes;
    last_index: (num_slots,) packed index of each slot's last real token
    (-1 = inactive slot: garbage logits row, length untouched).  Returns
    (logits (num_slots, V) at each slot's last token, state).  Each
    layer scatters the incoming K/V rows before attending, so a chunk
    attends its own tokens, matching :func:`prefill_chunk`.
    """
    check_supported(cfg)
    T = tokens.shape[0]
    st = dict(state)
    tables = st["tables"]
    M = tables.shape[-1]
    x = embed(tokens, params["embed"])                   # (T, D)
    positions = token_pos[None]                          # (1, T)
    blk = token_pos.long() // BLOCK_SIZE
    targets = _token_targets(tables, token_row.clamp(min=0), token_pos,
                             BLOCK_SIZE, keep=(token_row >= 0) & (blk < M))

    def ragged_attn(q, kvp):
        """q: (T, H, hd) over the fused (N, bs, KV*2, hd) layer pool."""
        if page_impl == "kernel":
            from repro_torch.kernels.paged_attention import ops as pa_ops
            return pa_ops.ragged_paged_attention(
                q, kvp, tables, tile_row, tile_pos, kv_lens,
                window=cfg.attn.window)
        if page_impl != "ref":
            raise ValueError(f"page_impl must be one of {PAGE_IMPLS}, "
                             f"got {page_impl!r}")
        from repro_torch.kernels.paged_attention.ref import ragged_fused_ref
        return ragged_fused_ref(q, kvp, tables, token_row, token_pos,
                                kv_lens, window=cfg.attn.window)

    attn_ids = attn_layer_ids(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, cfg, i)
        h = rms_norm(x[None], lp["mix"]["norm"], cfg.norm_eps)
        q, k, v = attn_mod.qkv_proj(lp["mix"], h, cfg, positions)
        kvp = st["kv"][attn_ids.index(i)]
        _scatter_rows(kvp, targets, attn_mod.fuse_kv(k[0], v[0]))
        o = ragged_attn(q[0], kvp)                       # (T, H, hd)
        x = x + o.reshape(T, -1) @ lp["mix"]["wo"]
        x = dense_ffn(lp["ffn"], x[None], cfg.norm_eps)[0]
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)  # (T, D)
    h_last = h[last_index.clamp(min=0).long()]           # (slots, D)
    logits = unembed(h_last[:, None], _unembed_table(params, cfg))[:, 0]
    n = st["lengths"].shape[0]
    st["lengths"] = torch.where(last_index >= 0,
                                kv_lens[:n].to(torch.int32), st["lengths"])
    return logits, st
