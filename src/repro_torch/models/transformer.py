"""Model assembly: init, prefill, chunked prefill, decode step, the
ragged mixed step, and the full-sequence forward and loss.

PyTorch counterpart of ``repro.models.transformer``: attention (GQA),
MLA, Mamba and RWKV-6 mixers, dense and MoE FFNs, the whisper encoder
and cross attention, and the vision prefix of InternVL2 (both frontends
stubs, as in the reference).  The decode state is a dict of tensors:

  kv:       fused K/V (L_attn, N, bs, KV*2, hd) paged GQA cache, head-
            interleaved (K even, V odd)
  mla_c:    (L, N, bs, rank) paged MLA latents, indexed by absolute layer
  mla_rope: (L, N, bs, rope_hd) paged MLA rope keys
  conv/ssm: (L_mamba, B, K-1, DI) model dtype / (L_mamba, B, DI, d_state)
            f32 Mamba states, per batch slot
  rwkv_x/rwkv_s: (L, B, D) model dtype / (L, B, nH, 64, 64) f32 RWKV-6
            token shift and WKV states, indexed by absolute layer
  cross_k/cross_v: (L, B, enc_len, KV, hd) whisper cross-attention keys
            and values, written once by prefill, per batch slot
  tables:   (W, Bs, M) int32 shard stack or (B, M) — FPR block tables
  lengths:  (B,) int32

Differences from the reference, all internal: the layer scan is a
Python loop over layers, and the pools and states are updated **in
place** (the reference returns new arrays) — a full-size pool is too
large to copy per layer, and a caller's batch-1 view of the per-slot
states receives its slot's update.  Writes the reference drops with ``mode="drop"`` (holes,
padding rows, columns past the table) go through ``layers.drop_write``:
torch indexing has no drop mode and wraps negative indices, and a write
of fixed length keeps every shape independent of the data.

``page_impl`` picks the decode/ragged attention: ``"kernel"`` (the CUDA
kernels in ``kernels/paged_attention`` and ``kernels/mla_attention``;
their plain versions on the CPU) or ``"ref"`` (the gather oracles).
``impl`` picks how :func:`prefill`, :func:`forward_hidden` and
:func:`loss_fn` scan the Mamba and RWKV-6 mixers: ``"chunked"``,
``"sequential"`` or ``"kernel"`` (the CUDA kernels in
``kernels/mamba_scan`` and ``kernels/rwkv6_scan``).  As in the reference,
``forward_hidden`` runs attention layers through ``chunked_attention``
when ``impl == "chunked"`` and through ``direct_attention`` otherwise,
while ``prefill`` always uses ``chunked_attention``; decode steps the
recurrences sequentially.  :func:`forward_hidden` and :func:`loss_fn`
are differentiable (the training stack in ``repro_torch.training`` runs
autograd through them): ``chunked_attention`` carries the reference's
flash-style backward, and ``remat`` checkpoints each body block of
``cfg.segmentation()`` (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scanned block) while the loss chunks and the
Mamba and RWKV-6 chunk steps are always checkpointed; the CUDA kernels
are forward only.  MLA and hybrid models prefill monolithically
(``prefill_chunk`` and ``ragged_step`` take attention-only decoder
models, as in the reference: no encoder-decoder).  ``impl="direct"``
runs attention through ``direct_attention`` in the forward and loss, as
the reference's does; the scans refuse it.

**On a device mesh** (``mesh``: a ``torch.distributed`` DeviceMesh, one
process per member, ``distributed/collectives.py``), ``decode_step``
takes ``page_impl="sp"`` or ``"sp_opt"`` (and only those), and
:func:`prefill` and :func:`decode_step` serve one of two ways.

* **From the rank's blocks** (``layout``: a ``distributed.parallel.
  Layout``), as the reference serves under ``param_specs``: ``params``
  are the rank's blocks (``sharding.shard_params``, or a checkpoint
  restored onto the mesh), and every input and output with a batch dim
  (tokens, patches, frames, the state's tables, lengths, cross and
  recurrent states, the logits) is the rank's rows over ``batch_axes``
  (``collectives.local_state(layout=)``).  Each layer gathers its
  data-split leaves just in time (``Layout.layer``, under
  ``torch.no_grad()``); attention (whatever its head count: each rank a
  block of ``⌈H/|model|⌉`` query heads or fewer), whisper's encoder and
  cross attention, every other mixer whose heads or channels split
  evenly over ``model`` and the dense FFN compute only the rank's heads,
  channels or columns, MoE layers run expert-parallel, and every other
  leaf (the frontends, an MLA, RWKV-6 or Mamba mixer whose heads or
  channels do not split) is gathered whole.  Whisper's encoder runs on
  the rank's batch rows, its layers gathered one by one like the
  decoder's, and its cross K/V state holds every KV head (computed whole
  in prefill; decode gathers no cross ``wk``/``wv``).  The paged pools hold every KV head
  and split the sequence: attention's K and V for the cache are whole
  or gathered over ``model`` (``attention.serving_qkv``), the SP decode
  takes every query head (gathered over ``model``) and its output's
  rank heads meet ``wo``'s row block; MLA gathers its absorbed queries
  the same way; a Mamba decode exchanges ``in_proj``'s outputs over
  ``model`` (``Layout.in_proj_exchange``).  The embedding and the
  logits are vocab-parallel, the logits gathered over ``model``.
* **From whole params** (``mesh`` alone): each rank holds its N rows of
  every paged pool (``collectives.local_state``), the whole tables,
  lengths and recurrent states, and the whole batch of activations.
  Attention runs the sequence-parallel decode on the rank's batch rows
  and pool shard and gathers the batch back; the embedding lookup is
  the vocab-parallel one over the rank's V rows of ``params["embed"]``
  (a view: the table stays whole, as a tied unembedding needs it).  MoE
  layers run expert-parallel over ``model`` where their experts split
  evenly over it (``sharding.expert_parallel``): each rank computes its
  ``E/|model|`` experts and its blocks of the shared experts, and the
  partial outputs are summed over ``model`` (``models/moe.py``).
  ``params`` may hold the whole expert stacks (compute takes a view of
  the rank's block) or only the rank's blocks
  (``sharding.expert_shards``); the size of the split dim tells which.
  Every other weight stays whole on every rank.

Either way the token writes and ``prefill``'s cache writes
(``scatter_seq_sp``) land only in the rank's own pool rows.

``moe_groups`` (:func:`prefill`, :func:`decode_step`,
:func:`prefill_chunk`, :func:`ragged_step`, as in the reference) routes
an MoE layer's tokens in that many groups of the whole token stream
(reduced until it divides the token count).

**Training on a mesh** passes a ``layout`` (``distributed.parallel.
Layout``) to :func:`loss_fn` and :func:`forward_hidden`: ``params`` are
then the rank's blocks under ``param_specs`` and the batch its rows.
Each layer (whisper's encoder layers too) gathers its data-sharded
leaves just in time, attention and its cross attention, every other
mixer whose heads or channels split evenly over ``model`` and the dense
FFN run tensor-parallel and MoE layers expert-parallel (``distributed/
parallel.py``), every other leaf runs whole, the loss is vocab-parallel
and normalised by the global label count, and MoE layers route the
reference's groups of the global token stream; the result is the rank's
share of the reference's loss. The reference's ``_constrain`` (a
sharding constraint on the activations) has no eager meaning, so it has
none here; its ``act_spec`` picks which batch rows a rank embeds, and
here a rank embeds the rows it is given.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import recorder as trace_rec
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import (audio_frames_to_embeddings,
                                          init_frontend,
                                          vision_patches_to_embeddings)
from repro_torch.models.layers import (dense_ffn, drop_index, drop_write,
                                       embed, init_dense, init_embed,
                                       init_swiglu, rms_norm, unembed)
from repro_torch.models.layers import remat as checkpointed

BLOCK_SIZE = 128   # tokens per physical KV block

PAGE_IMPLS = ("ref", "kernel", "sp", "sp_opt")
#: the page_impls of a mesh: the sequence-parallel decode, walking every
#: table column ("sp") or only the rank's own ("sp_opt")
SP_IMPLS = ("sp", "sp_opt")
#: how the Mamba and RWKV-6 mixers scan a sequence, and whether the
#: forward's attention is chunked (see the module doc)
IMPLS = ("chunked", "sequential", "kernel", "direct")
#: rows of the decoder's learned positions (``dec_pos``); later positions
#: reuse the last row, as in the reference
DEC_POS = 4096

_MIXERS = {"attn": attn_mod.init_attn, "mla": mla_mod.init_mla,
           "mamba": mamba_mod.init_mamba, "rwkv6": rwkv_mod.init_rwkv6}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a mixer outside attention, MLA, Mamba and RWKV-6."""
    for kind in sorted(set(cfg.mixers) - set(_MIXERS)):
        raise ValueError(f"unknown mixer {kind!r}")


# ============================================================ initialisation
def _init_layer(cfg: ModelConfig, i: int, *, generator, device,
                dtype) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    mix, ffn_kind = cfg.layer_sig(i)
    ffn = (moe_mod.init_moe(cfg, **kw) if ffn_kind == "moe"
           else _init_dense_ffn(cfg, **kw))
    lp = {"mix": _MIXERS[mix](cfg, **kw), "ffn": ffn}
    if cfg.enc_dec:
        lp["cross"] = _init_cross(cfg, **kw)
    return lp


def _init_dense_ffn(cfg: ModelConfig, *, generator, device, dtype) -> dict:
    ffn = init_swiglu(cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                      generator=generator, device=device, dtype=dtype)
    ffn["norm"] = torch.ones(cfg.d_model, device=device, dtype=dtype)
    return ffn


def _init_cross(cfg: ModelConfig, *, generator, device, dtype) -> dict:
    D, H, KV, HD = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {"norm": torch.ones(D, device=device, dtype=dtype),
            "wq": init_dense(D, H * HD, **kw),
            "wk": init_dense(D, KV * HD, **kw),
            "wv": init_dense(D, KV * HD, **kw),
            "wo": init_dense(H * HD, D, **kw)}


def _init_encoder(cfg: ModelConfig, *, generator, device, dtype) -> dict:
    """The whisper encoder: ``enc_layers`` attention + dense-FFN layers and
    the learned encoder and decoder positions."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    encoder = [{"mix": attn_mod.init_attn(cfg, **kw),
                "ffn": _init_dense_ffn(cfg, **kw)}
               for _ in range(cfg.enc_layers)]

    def positions(rows):
        return (torch.randn(rows, cfg.d_model, generator=generator,
                            device=device) * 0.02).to(dtype)
    return {"encoder": encoder, "enc_pos": positions(cfg.enc_len),
            "dec_pos": positions(DEC_POS)}


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> dict:
    """Random parameters made directly on ``device`` from ``generator``.

    Same keys and shapes as the reference; ``params["body"][j]`` is a
    list over blocks of per-layer dicts (the reference stacks them along
    axis 0 for its scan), ``params["encoder"]`` a list of layer dicts.
    """
    check_supported(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)
    prefix, period = cfg.segmentation()
    params = {"embed": init_embed(cfg.vocab, cfg.d_model, **kw),
              "final_norm": torch.ones(cfg.d_model, device=device,
                                       dtype=dtype)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_embed(cfg.vocab, cfg.d_model, **kw)
    params.update(init_frontend(cfg, **kw))
    params["prefix"] = [_init_layer(cfg, i, **kw) for i in range(prefix)]
    n_blocks = (cfg.n_layers - prefix) // period if period else 0
    params["body"] = [[_init_layer(cfg, prefix + b * period + j, **kw)
                       for b in range(n_blocks)] for j in range(period)]
    if cfg.enc_dec:
        params.update(_init_encoder(cfg, **kw))
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


def _ffn_aux(lp: dict, x: torch.Tensor, cfg: ModelConfig, i: int,
             moe_groups: int = 1, tp=None, dp=None):
    """Layer ``i``'s FFN on (B, S, D) → (x, aux loss).  An MoE layer
    routes the B·S tokens, padding included, in ``moe_groups`` groups
    exactly as the reference does (on a mesh, ``dp``: the groups of the
    global stream), expert-parallel under ``tp`` (its experts, whole or
    the rank's blocks, viewed as the rank's blocks); a dense layer's aux
    is 0 (``tp``: tensor-parallel)."""
    rec = trace_rec.ACTIVE
    if cfg.ffns[i] == "moe":
        if rec is not None:
            rec.model(None)           # moe_ffn opens model.moe itself
        ffn = lp["ffn"]
        if tp is not None:
            from repro_torch.distributed.sharding import expert_blocks
            ffn = expert_blocks(ffn, cfg, tp.size, tp.index)
        return moe_mod.moe_ffn(ffn, x, cfg, num_groups=moe_groups, dp=dp,
                               ep=tp)
    if rec is not None:
        rec.model("model.ffn")
    return dense_ffn(lp["ffn"], x, cfg.norm_eps, tp), 0.0


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig, i: int,
         moe_groups: int = 1) -> torch.Tensor:
    """Layer ``i``'s FFN for the single-device serving paths (no aux
    loss)."""
    return _ffn_aux(lp, x, cfg, i, moe_groups)[0]


def _serving_ep(cfg: ModelConfig, mesh):
    """The expert-parallel map of serving on ``mesh``: ``model``'s, where
    the config's experts split evenly over it, else None."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    from repro_torch.distributed.parallel import TensorParallel
    from repro_torch.distributed.sharding import expert_parallel
    ep = TensorParallel(mesh)
    return ep if expert_parallel(cfg, ep.size) else None


def _check_attn_only(cfg: ModelConfig, what: str) -> None:
    if any(m != "attn" for m in cfg.mixers) or cfg.enc_dec:
        raise NotImplementedError(
            f"{what} supports attention-mixer, decoder-only models; got "
            f"mixers={cfg.mixers} enc_dec={cfg.enc_dec}")


# ============================================================= decode state
def attn_layer_ids(cfg: ModelConfig) -> list[int]:
    return [i for i in range(cfg.n_layers) if cfg.mixers[i] == "attn"]


def mamba_layer_ids(cfg: ModelConfig) -> list[int]:
    return [i for i in range(cfg.n_layers) if cfg.mixers[i] == "mamba"]


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
    if "mla" in cfg.mixers:
        m = cfg.mla
        spec["mla_c"] = ((cfg.n_layers, N, bs, m.kv_lora_rank), dtype)
        spec["mla_rope"] = ((cfg.n_layers, N, bs, m.rope_head_dim), dtype)
    n_attn = len(attn_layer_ids(cfg))
    if n_attn:
        spec["kv"] = ((n_attn, N, bs, 2 * cfg.n_kv_heads, cfg.head_dim),
                      dtype)
    n_mamba = len(mamba_layer_ids(cfg))
    if n_mamba:
        mm = cfg.mamba
        spec["conv"] = ((n_mamba, batch, mm.d_conv - 1, cfg.d_inner), dtype)
        spec["ssm"] = ((n_mamba, batch, cfg.d_inner, mm.d_state),
                       torch.float32)
    if "rwkv6" in cfg.mixers:
        L, hs = cfg.n_layers, rwkv_mod.HEAD_SIZE
        spec["rwkv_x"] = ((L, batch, cfg.d_model), dtype)
        spec["rwkv_s"] = ((L, batch, cfg.d_model // hs, hs, hs),
                          torch.float32)
    if cfg.enc_dec:
        cross = (cfg.n_layers, batch, cfg.enc_len, cfg.n_kv_heads,
                 cfg.head_dim)
        spec["cross_k"] = (cross, dtype)
        spec["cross_v"] = (cross, dtype)
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
        pool = spec.get("kv", spec.get("mla_c"))
        N = pool[0][1] if pool else batch * M
        st["tables"] = sp_identity_tables(batch, M, N, batch_shards,
                                          seq_shards, device)
    if lengths is not None:
        st["lengths"] = lengths
    return st


# ============================================================ cache writes
def _token_targets(tables: torch.Tensor, slots: torch.Tensor,
                   pos: torch.Tensor, bs: int,
                   keep: torch.Tensor | None = None):
    """Where one token per entry lands in a (N, bs, …) pool: each entry's
    (block, offset) as a ``layers.drop_index``, computed once for every
    layer's pool.  Entries mapped to a hole (< 0) — or excluded by
    ``keep`` — are dropped."""
    M = tables.shape[-1]
    blk = pos.long() // bs
    phys = attn_mod.lookup_slot_blocks(tables, slots.long(),
                                       blk.clamp(max=M - 1))
    land = phys >= 0 if keep is None else keep & (phys >= 0)
    return drop_index((phys, pos.long() % bs), land)


def _write_token_kv(pool, tables, lengths, new, bs):
    """Scatter one token's cache row per slot into the paged pool, in
    place.  pool: (N, bs, ...); new: (B, ...); the position is
    ``lengths``.  Non-resident (<0) table entries drop the write."""
    B = new.shape[0]
    slots = torch.arange(B, device=new.device)
    drop_write(pool, _token_targets(tables, slots, lengths, bs), new)
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
    drop_write(pool, drop_index((tab,), tab >= 0), seq)


# ================================================================ decode step
def _sp_shards(tables, B, page_impl, mesh, batch_axes, seq_axes, *rows,
               rows_local=False):
    """This rank's part of the SP decode's inputs: its batch rows of the
    monolithic view of ``tables`` (and, for ``"sp_opt"``, its columns)
    and of each of ``rows``; with ``rows_local`` (serving under a
    layout) the rows are the rank's already and only the columns are
    cut."""
    from repro_torch.distributed.collectives import local_shard
    ba = () if rows_local else tuple(batch_axes)
    cols = tuple(seq_axes) if page_impl == "sp_opt" else None
    tab = local_shard(attn_mod.assemble_shard_tables(tables)[:B],
                      (ba, cols), mesh)
    return tab, [local_shard(x, (ba,), mesh) for x in rows]


def _paged_attn(q, kv_pool, tables, lengths, *, page_impl, window,
                mesh=None, batch_axes=(), seq_axes=(), rows_local=False):
    """One decode-attention step over either table layout: ``kv_pool`` is
    the fused ``(N, bs, KV*2, hd)`` pool (on a mesh the rank's N rows),
    ``tables`` the ``(B, M)`` table or the ``(W, Bs, M)`` shard stack.
    On a mesh the SP decode runs on the rank's batch rows and gathers
    the batch back, unless ``rows_local``: q, tables and lengths are the
    rank's rows, and so is the output."""
    if page_impl in SP_IMPLS:
        from repro_torch.distributed import collectives as coll
        B = q.shape[0]
        tab, (q_l, len_l) = _sp_shards(tables, B, page_impl, mesh,
                                       batch_axes, seq_axes, q, lengths,
                                       rows_local=rows_local)
        k_pool, v_pool = attn_mod.split_fused_kv(kv_pool)
        out = coll.paged_decode_attention_sp(
            q_l, k_pool, v_pool, tab, len_l, mesh=mesh,
            batch_axes=batch_axes, seq_axes=seq_axes, window=window,
            table_cols_sharded=(page_impl == "sp_opt"))
        return out if rows_local else coll.gather_batch(
            out, mesh, tuple(batch_axes), B)
    if page_impl == "kernel":
        from repro_torch.kernels.paged_attention import autotune
        from repro_torch.kernels.paged_attention import ops as pa_ops
        _, bs, KV2, hd = kv_pool.shape
        tuned = autotune.get_tuning(KV2 // 2, hd, bs, dtype=kv_pool.dtype)
        return pa_ops.paged_attention(q, kv_pool, tables, lengths,
                                      window=window,
                                      buffer_depth=tuned.buffer_depth)
    _check_page_impl(page_impl)
    B = q.shape[0]
    k_pool, v_pool = attn_mod.split_fused_kv(kv_pool)
    return attn_mod.paged_decode_attention_ref(
        q, k_pool, v_pool, attn_mod.assemble_shard_tables(tables)[:B],
        lengths, window=window)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _check_page_impl(page_impl: str) -> None:
    if page_impl not in PAGE_IMPLS:
        raise ValueError(f"page_impl must be one of {PAGE_IMPLS}, "
                         f"got {page_impl!r}")


def _mla_paged_decode(lp, x, positions, st, layer, cfg, *, page_impl,
                      mesh=None, batch_axes=(), seq_axes=(),
                      rows_local=False, tp=None):
    """Absorbed-MLA decode of layer ``layer`` over the latent pools:
    ``"kernel"`` walks the table (either layout) in the CUDA kernel;
    ``"ref"`` gathers through the monolithic view of the table; the SP
    impls run ``mla_decode_sp`` on the rank's batch rows and pool shard
    and gather the batch back (``rows_local`` and ``tp``: as
    :func:`_paged_attn` and ``mla_decode_sp`` take them)."""
    c_pool, rope_pool = st["mla_c"][layer], st["mla_rope"][layer]
    if page_impl in SP_IMPLS:
        from repro_torch.distributed import collectives as coll
        B = x.shape[0]
        tab, (x_l, pos_l, len_l) = _sp_shards(
            st["tables"], B, page_impl, mesh, batch_axes, seq_axes, x,
            positions, st["lengths"] + 1, rows_local=rows_local)
        out = coll.mla_decode_sp(
            lp, x_l, pos_l, c_pool, rope_pool, tab, len_l, cfg, mesh=mesh,
            batch_axes=batch_axes, seq_axes=seq_axes,
            table_cols_sharded=(page_impl == "sp_opt"), tp=tp)
        return out if rows_local else coll.gather_batch(
            out, mesh, tuple(batch_axes), B)
    if page_impl == "kernel":
        from repro_torch.kernels.mla_attention import ops as mla_ops
        return mla_ops.mla_paged_decode(lp, x, positions, c_pool, rope_pool,
                                        st["tables"], st["lengths"] + 1, cfg)
    _check_page_impl(page_impl)
    tables = attn_mod.assemble_shard_tables(st["tables"])[:x.shape[0]]
    return mla_mod.mla_decode_ref(lp, x, positions, c_pool, rope_pool,
                                  tables, st["lengths"] + 1, cfg)


def _embed_tokens(params, tokens, mesh, layout=None):
    """The embedding lookup; vocab-parallel on a mesh with ``"model"``
    (over the rank's rows of the whole table, or under a ``layout`` over
    the rows it holds)."""
    if layout is not None:
        if layout.tp is None:
            return embed(tokens, params["embed"])
        from repro_torch.distributed import collectives as coll
        return coll.vocab_parallel_embed(tokens, params["embed"], mesh=mesh,
                                         vocab=layout.vocab)
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return embed(tokens, params["embed"])
    from repro_torch.distributed import collectives as coll
    return coll.vocab_parallel_embed(
        tokens, coll.vocab_shard(params["embed"], mesh), mesh=mesh,
        vocab=params["embed"].shape[0])


def _layer_where(cfg: ModelConfig, i: int) -> tuple:
    """Where layer ``i``'s params sit in the params tree."""
    prefix, period = cfg.segmentation()
    if i < prefix:
        return ("prefix", i)
    return ("body", (i - prefix) % period, (i - prefix) // period)


#: the leaves only prefill reads: the encoder, its positions and the
#: frontends (top level), the cross attention's keys and values (a
#: layer's, written to the state once); a decode step under a layout
#: gathers none of them, as GSPMD gathers no leaf the step never reads
PREFILL_ONLY = ("encoder", "enc_pos", "vision_proj", "audio_proj")
PREFILL_ONLY_CROSS = ("wk", "wv")


def _serving_layer(params, cfg: ModelConfig, i: int, layout, step: str,
                   ep):
    """Layer ``i``'s params for serving and the tps of its mixer and FFN:
    under a ``layout`` those of ``Layout.layer`` (its blocks gathered
    just in time, ``step`` ``"prefill"`` or ``"decode"``, which gathers
    no :data:`PREFILL_ONLY_CROSS` leaf); else the params as held, the
    mixer whole and an MoE layer expert-parallel under ``ep``."""
    lp = layer_params(params, cfg, i)
    if layout is None:
        return lp, None, ep if cfg.ffns[i] == "moe" else None
    if step == "decode" and "cross" in lp:
        lp = dict(lp, cross={k: v for k, v in lp["cross"].items()
                             if k not in PREFILL_ONLY_CROSS})
    return layout.layer(lp, _layer_where(cfg, i), i, step)


def _serving_dp(layout, batch_axes):
    """MoE routing's data-parallel map under a ``layout``: its data dims
    where the batch rows split over them, None where every rank holds
    the whole batch (``sharding.decode_axes``)."""
    if layout is None or not tuple(batch_axes):
        return None
    if tuple(batch_axes) != layout.dp.axes:
        raise ValueError(f"batch axes {tuple(batch_axes)} are not the "
                         f"layout's data dims {layout.dp.axes}")
    return layout.dp


def _logits(params, cfg: ModelConfig, h, layout):
    """h (B, D) normed → (B, V) f32 logits (vocab-parallel, gathered over
    ``model``, under a ``layout``)."""
    table = _unembed_table(params, cfg)
    if layout is not None:
        return layout.logits(h, table)
    return unembed(h[:, None], table)[:, 0]


def _attn_qkv(lp, h, cfg, positions, tp):
    """(q, k, v, fused K/V of every KV head for the cache): the rank's
    heads under ``tp`` (``attention.serving_qkv``), else every head."""
    if tp is not None:
        return attn_mod.serving_qkv(lp, h, cfg, positions, tp)
    q, k, v = attn_mod.qkv_proj(lp, h, cfg, positions)
    return q, k, v, attn_mod.fuse_kv(k, v)


def decode_step(params, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                *, page_impl: str = "ref", mesh=None, batch_axes=(),
                seq_axes=(), moe_groups: int = 1, layout=None,
                graphs=None):
    """One decode step: tokens (B,) → (logits (B, V) f32, state).

    ``state['lengths']`` counts tokens already in the cache; the incoming
    token is written at position ``lengths`` and attends to ``lengths+1``
    tokens (itself included).  Mamba and RWKV-6 layers step their states
    sequentially.  The pools and states are updated in place.  On a
    ``mesh`` (the module doc), ``page_impl`` is ``"sp"`` or ``"sp_opt"``,
    the pools are the rank's shards under ``batch_axes + seq_axes``, MoE
    layers run expert-parallel and every rank returns the whole logits.
    MoE layers route the B tokens in ``moe_groups`` groups.

    With a ``layout`` (``distributed.parallel.Layout``: serving from the
    rank's blocks, the module doc) the mesh is ``layout.mesh``,
    ``params`` are the rank's blocks under ``param_specs``, and
    ``tokens``, the state (``collectives.local_state(layout=)``) and the
    logits are the rank's batch rows over ``batch_axes``: B is the
    rank's row count.  ``coll.gather_batch`` gives a caller the whole
    batch.

    ``graphs`` (a ``decode_graphs.DecodeGraphs``, which its caller keeps
    from step to step) serves the step through its piecewise CUDA graphs
    where they take the config and ``page_impl`` and there is no mesh;
    the result is this function's without them.
    """
    check_supported(cfg)
    if layout is not None:
        mesh = layout.mesh
    if (page_impl in SP_IMPLS) != (mesh is not None):
        raise ValueError(f"page_impl {page_impl!r} "
                         f"{'needs' if mesh is None else 'does not take'} "
                         f"a mesh; on a mesh use one of {SP_IMPLS}")
    if (graphs is not None and mesh is None
            and graphs.takes(cfg, page_impl)):
        return graphs.step(params, cfg, state, tokens, moe_groups)
    kw = dict(page_impl=page_impl, mesh=mesh, batch_axes=batch_axes,
              seq_axes=seq_axes, moe_groups=moe_groups)
    if layout is None:
        return _decode_step(params, cfg, state, tokens, **kw)
    with torch.no_grad():
        top = layout.top({k: v for k, v in params.items()
                          if k not in PREFILL_ONLY})
        return _decode_step(top, cfg, state, tokens, layout=layout, **kw)


def _decode_step(params, cfg: ModelConfig, state: dict, tokens, *,
                 page_impl, mesh, batch_axes, seq_axes, moe_groups,
                 layout=None):
    rec = trace_rec.ACTIVE
    if rec is not None:
        rec.model("model.embed")
    B = tokens.shape[0]
    st = dict(state)
    pos = st["lengths"]
    x = _embed_tokens(params, tokens, mesh, layout)      # (B, D)
    if cfg.enc_dec:
        x = x + params["dec_pos"][pos.long().clamp(max=DEC_POS - 1)]
    positions = pos[:, None]
    tables = st["tables"]
    pool = st.get("kv", st.get("mla_c"))
    if mesh is not None and pool is not None:   # only this rank's pool
        from repro_torch.distributed.collectives import local_tables
        Nl = pool.shape[1]                      # rows are written
        tables = local_tables(
            attn_mod.assemble_shard_tables(tables)[:B], mesh,
            tuple(batch_axes), tuple(seq_axes), Nl)
    targets = _token_targets(tables, torch.arange(B, device=tokens.device),
                             pos, BLOCK_SIZE)
    attn_ids = attn_layer_ids(cfg)
    mamba_ids = mamba_layer_ids(cfg)
    ep = _serving_ep(cfg, mesh) if layout is None else None
    dp = _serving_dp(layout, batch_axes)
    sp = dict(page_impl=page_impl, mesh=mesh, batch_axes=batch_axes,
              seq_axes=seq_axes, rows_local=layout is not None)
    for i in range(cfg.n_layers):
        mix = cfg.mixers[i]
        if rec is not None:
            rec.model(trace_rec.MIXER_RANGE[mix])
        lp, tp, tp_ffn = _serving_layer(params, cfg, i, layout, "decode", ep)
        if mix == "mamba":
            m = mamba_ids.index(i)
            x, (cs, ss) = mamba_mod.mamba_decode_step(
                lp["mix"], x, cfg, st["conv"][m], st["ssm"][m], tp)
            st["conv"][m] = cs
            st["ssm"][m] = ss
        elif mix == "rwkv6":
            x, (lx, s_new) = rwkv_mod.rwkv6_decode_step(
                lp["mix"], x, cfg, st["rwkv_x"][i], st["rwkv_s"][i], tp)
            st["rwkv_x"][i] = lx
            st["rwkv_s"][i] = s_new
        elif mix == "mla":
            h = rms_norm(x[:, None], lp["mix"]["norm"], cfg.norm_eps)
            c_kv, k_rope = mla_mod.latent_kv(lp["mix"], h, cfg, positions)
            drop_write(st["mla_c"][i], targets, c_kv[:, 0])
            drop_write(st["mla_rope"][i], targets, k_rope[:, 0, 0])
            x = _mla_paged_decode(lp["mix"], x, pos, st, i, cfg, tp=tp,
                                  **sp)
        else:
            a = attn_ids.index(i)
            h = rms_norm(x[:, None], lp["mix"]["norm"], cfg.norm_eps)
            q, _, _, kv = _attn_qkv(lp["mix"], h, cfg, positions, tp)
            drop_write(st["kv"][a], targets, kv[:, 0])
            if tp is not None:          # the SP decode takes every head
                q = tp.gather(q, 2, cfg.n_heads)
            o = _paged_attn(q[:, 0], st["kv"][a], st["tables"], pos + 1,
                            window=cfg.attn.window, **sp)
            if tp is not None:          # back to the rank's heads
                o = tp.cut(o, 1)
            x = x + attn_mod.out_proj(o, lp["mix"]["wo"], cfg, tp)
        if cfg.enc_dec:
            x = attn_mod.cross_attn_layer(
                lp["cross"], x[:, None],
                (st["cross_k"][i], st["cross_v"][i]), cfg, tp)[:, 0]
        x = _ffn_aux(lp, x[:, None], cfg, i, moe_groups, tp_ffn, dp)[0][:, 0]
        lp = None                   # drop the layer before the next gathers
    if rec is not None:
        rec.model("model.head")
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, h, layout)
    if rec is not None:
        rec.model(None)
    st["lengths"] = pos + 1
    return logits, st


# ================================================================== prefill
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, state: dict, *,
            impl: str = "chunked", enc_frames: torch.Tensor | None = None,
            patches: torch.Tensor | None = None, moe_groups: int = 1,
            mesh=None, batch_axes=(), seq_axes=("model",), layout=None,
            graphs=None):
    """Process a full prompt, write every cache and recurrent state (in
    place), return (last_logits, state).  tokens: (B, S); a vision model's
    ``patches`` (B, P, D) go before the text, so the sequence is S_tot =
    P + S long and token t of it (prefix included) lands at
    pool[tables[b, t//bs], t%bs].  An encoder-decoder model encodes
    ``enc_frames`` (B, enc_len, D) once and writes each layer's
    cross-attention keys and values.  ``impl`` scans the Mamba and RWKV-6
    mixers (:data:`IMPLS`); attention layers always run
    ``chunked_attention``, as in the reference.  On a ``mesh`` the pools
    are the rank's shards under ``batch_axes + seq_axes`` and each rank
    writes only its own rows (``scatter_seq_sp``, whatever the mesh's
    dims: the pools are always local here), MoE layers run
    expert-parallel, and the rest runs whole on every rank.  MoE layers
    route the B·S_tot tokens in ``moe_groups`` groups.

    With a ``layout`` (``distributed.parallel.Layout``: serving from the
    rank's blocks, the module doc) the mesh is ``layout.mesh``,
    ``params`` are the rank's blocks under ``param_specs``, and
    ``tokens``, ``patches``, ``enc_frames``, the state
    (``collectives.local_state(layout=)``) and the logits are the rank's
    batch rows over ``batch_axes``; MoE layers route the reference's
    ``moe_groups`` groups of the global token stream.

    ``graphs`` (a ``prefill_graphs.PrefillGraphs``, which its caller
    keeps from call to call) serves the call through a CUDA graph of its
    padded length where they take the config and there is no mesh,
    layout, encoder input or vision prefix; the result is this
    function's without them."""
    check_supported(cfg)
    _check_impl(impl)
    if (graphs is not None and mesh is None and layout is None
            and enc_frames is None and patches is None
            and graphs.takes(cfg)):
        return graphs.prefill(params, cfg, tokens, state, impl=impl,
                              moe_groups=moe_groups)
    kw = dict(impl=impl, enc_frames=enc_frames, patches=patches,
              moe_groups=moe_groups, batch_axes=batch_axes,
              seq_axes=seq_axes)
    if layout is None:
        return _prefill(params, cfg, tokens, state, mesh=mesh, **kw)
    with torch.no_grad():
        return _prefill(layout.top(params), cfg, tokens, state,
                        mesh=layout.mesh, layout=layout, **kw)


def _prefill(params, cfg: ModelConfig, tokens, state, *, impl, enc_frames,
             patches, moe_groups, mesh, batch_axes, seq_axes, layout=None):
    rec = trace_rec.ACTIVE
    if rec is not None:
        rec.model("model.embed")
    B = tokens.shape[0]
    bs = BLOCK_SIZE
    st = dict(state)
    enc_out = (encode(params, cfg, enc_frames, layout) if cfg.enc_dec
               else None)
    x = embed_inputs(params, cfg, tokens, patches, mesh=mesh, layout=layout)
    S = x.shape[1]                                       # S_tot
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    tables = attn_mod.assemble_shard_tables(st["tables"])[:B]
    M_used = -(-S // bs)
    tab = tables[:, :M_used].reshape(-1)

    def scatter_seq(pool, seq):
        """seq (B, S_tot, ...) → the prompt's pool rows; <0 entries
        drop."""
        pad = [0, 0] * (seq.dim() - 2) + [0, M_used * bs - S]
        seq = torch.nn.functional.pad(seq, pad)
        rows = seq.reshape((B * M_used, bs) + seq.shape[2:])
        if mesh is None:
            _scatter_blocks(pool, tab, rows)
            return
        from repro_torch.distributed import collectives as coll
        t = tab
        if layout is None:                  # cut the rank's batch rows
            ba = (tuple(batch_axes),)
            rows, t = (coll.local_shard(r, ba, mesh) for r in (rows, tab))
        coll.scatter_seq_sp(pool, rows, t, mesh=mesh,
                            batch_axes=batch_axes, seq_axes=seq_axes)

    attn_ids = attn_layer_ids(cfg)
    mamba_ids = mamba_layer_ids(cfg)
    ep = _serving_ep(cfg, mesh) if layout is None else None
    dp = _serving_dp(layout, batch_axes)
    for i in range(cfg.n_layers):
        mix = cfg.mixers[i]
        if rec is not None:
            rec.model(trace_rec.MIXER_RANGE[mix])
        lp, tp, tp_ffn = _serving_layer(params, cfg, i, layout, "prefill",
                                        ep)
        h = rms_norm(x, lp["mix"]["norm"], cfg.norm_eps)
        if mix == "mla":
            # the cache holds the latents of the layer's input
            c_kv, k_rope = mla_mod.latent_kv(lp["mix"], h, cfg, positions)
            x = mla_mod.mla_layer(lp["mix"], x, positions, cfg, tp=tp)
            scatter_seq(st["mla_c"][i], c_kv)
            scatter_seq(st["mla_rope"][i], k_rope[:, :, 0])
        elif mix == "mamba":
            y, (cs, ss) = mamba_mod.mamba_mix(lp["mix"], h, cfg, impl=impl,
                                              tp=tp)
            x = x + y
            m = mamba_ids.index(i)
            st["conv"][m] = cs
            st["ssm"][m] = ss
        elif mix == "rwkv6":
            y, (lx, s_new) = rwkv_mod.rwkv6_mix(lp["mix"], h, cfg, impl=impl,
                                                tp=tp)
            x = x + y
            st["rwkv_x"][i] = lx
            st["rwkv_s"][i] = s_new
        else:
            q, k, v, kv = _attn_qkv(lp["mix"], h, cfg, positions, tp)
            o = attn_mod.chunked_attention(q, k, v, causal=True,
                                           window=cfg.attn.window)
            x = x + attn_mod.out_proj(o, lp["mix"]["wo"], cfg, tp)
            scatter_seq(st["kv"][attn_ids.index(i)], kv)
        if cfg.enc_dec:
            kc, vc = attn_mod.encode_cross_kv(lp["cross"], enc_out, cfg)
            x = attn_mod.cross_attn_layer(lp["cross"], x, (kc, vc), cfg, tp)
            st["cross_k"][i] = kc
            st["cross_v"][i] = vc
        x = _ffn_aux(lp, x, cfg, i, moe_groups, tp_ffn, dp)[0]
        lp = None                   # drop the layer before the next gathers
    if rec is not None:
        rec.model("model.head")
    h = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, h, layout)
    if rec is not None:
        rec.model(None)
    st["lengths"] = torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)
    return logits, st


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                  state: dict, start: int, *, moe_groups: int = 1) -> dict:
    """One fixed-shape prefill chunk: tokens (B, C) at positions
    ``start .. start+C-1`` (C a BLOCK_SIZE multiple, ``start``
    block-aligned).

    Each layer scatters the chunk's K/V rows into the pool at the chunk's
    table columns, then attends the full gathered window with
    ``q_offset=start``.  Keys past the causal frontier are garbage pool
    rows that the mask turns into exact zeros (``exp(NEG_INF - m)``
    underflows to 0.0), so every real query row matches :func:`prefill`.
    Returns the state; logits are not computed (the first decode step
    rewrites position S−1 and produces them).  Attention mixers only;
    MoE layers route the B·C tokens in ``moe_groups`` groups.
    """
    check_supported(cfg)
    _check_attn_only(cfg, "prefill_chunk")
    B, C = tokens.shape
    bs = BLOCK_SIZE
    if C % bs:
        raise ValueError(f"chunk length {C} must be a multiple of "
                         f"BLOCK_SIZE={bs}")
    rec = trace_rec.ACTIVE
    if rec is not None:
        rec.model("model.embed")
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
        if rec is not None:
            rec.model("model.attn")
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
        x = _ffn(lp, x, cfg, i, moe_groups)
    if rec is not None:
        rec.model(None)
    return st


def ragged_step(params, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                token_row: torch.Tensor, token_pos: torch.Tensor,
                tile_row: torch.Tensor, tile_pos: torch.Tensor,
                kv_lens: torch.Tensor, last_index: torch.Tensor, *,
                page_impl: str = "ref", moe_groups: int = 1):
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
    attends its own tokens, matching :func:`prefill_chunk`.  Attention
    mixers only; an MoE layer routes the whole fixed-capacity stream,
    padding included, in ``moe_groups`` groups.
    """
    check_supported(cfg)
    _check_attn_only(cfg, "ragged_step")
    rec = trace_rec.ACTIVE
    if rec is not None:
        rec.model("model.embed")
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
        _check_page_impl(page_impl)
        from repro_torch.kernels.paged_attention.ref import ragged_fused_ref
        return ragged_fused_ref(q, kvp, tables, token_row, token_pos,
                                kv_lens, window=cfg.attn.window)

    attn_ids = attn_layer_ids(cfg)
    for i in range(cfg.n_layers):
        if rec is not None:
            rec.model("model.attn")
        lp = layer_params(params, cfg, i)
        h = rms_norm(x[None], lp["mix"]["norm"], cfg.norm_eps)
        q, k, v = attn_mod.qkv_proj(lp["mix"], h, cfg, positions)
        kvp = st["kv"][attn_ids.index(i)]
        drop_write(kvp, targets, attn_mod.fuse_kv(k[0], v[0]))
        o = ragged_attn(q[0], kvp)                       # (T, H, hd)
        x = x + o.reshape(T, -1) @ lp["mix"]["wo"]
        x = _ffn(lp, x[None], cfg, i, moe_groups)[0]
    if rec is not None:
        rec.model("model.head")
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)  # (T, D)
    h_last = h[last_index.clamp(min=0).long()]           # (slots, D)
    logits = unembed(h_last[:, None], _unembed_table(params, cfg))[:, 0]
    if rec is not None:
        rec.model(None)
    n = st["lengths"].shape[0]
    st["lengths"] = torch.where(last_index >= 0,
                                kv_lens[:n].to(torch.int32), st["lengths"])
    return logits, st


# ===================================================== full-sequence forward
def encode(params, cfg: ModelConfig, frames: torch.Tensor,
           layout=None) -> torch.Tensor:
    """Whisper encoder: frames (B, enc_len, D) → enc_out (B, enc_len, D).
    Non-causal ``chunked_attention`` with no rope, as in the reference.
    With a ``layout`` (``distributed.parallel.Layout``) ``params`` are as
    ``Layout.top`` gives them (the encoder's layers the rank's blocks)
    and ``frames`` the rank's rows: each layer is gathered just in time
    (``Layout.encoder_layer``), its attention computes the rank's query
    heads and its dense FFN the rank's columns."""
    x = audio_frames_to_embeddings(params, frames)
    x = x + params["enc_pos"][None, :x.shape[1]]
    for j, lp in enumerate(params["encoder"]):
        tp = tp_ffn = None
        if layout is not None:
            lp, tp, tp_ffn = layout.encoder_layer(lp, j)
        x = attn_mod.attn_layer(lp["mix"], x, None, cfg, tp=tp, causal=False)
        x = dense_ffn(lp["ffn"], x, cfg.norm_eps, tp_ffn)
        lp = None                   # drop the layer before the next gathers
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                 patches: torch.Tensor | None = None, *,
                 mesh=None, layout=None) -> torch.Tensor:
    """tokens (B, S_text) [+ patches (B, P, D)] → x (B, S, D): a vision
    prefix goes before the text; an encoder-decoder model adds its
    learned decoder positions.  On a mesh with ``"model"`` the lookup is
    the vocab-parallel one (the module doc)."""
    check_supported(cfg)
    x = _embed_tokens(params, tokens, mesh, layout)
    if cfg.frontend == "vision" and patches is not None:
        vis = vision_patches_to_embeddings(params, patches)
        x = torch.cat([vis.to(x.dtype), x], dim=1)
    if cfg.enc_dec:
        rows = torch.arange(x.shape[1], device=x.device).clamp(
            max=DEC_POS - 1)
        x = x + params["dec_pos"][rows][None]
    return x


def _apply_layer(lp, x, positions, cfg: ModelConfig, i: int, *, impl,
                 enc_out=None, moe_groups=1, tp=(None, None), dp=None):
    """Layer ``i`` on (B, S, D) → (x, aux loss); ``tp`` (mixer, FFN: an
    MoE layer's expert-parallel map) and ``dp`` as
    :meth:`distributed.parallel.Layout.layer` gives them."""
    mix = cfg.mixers[i]
    if mix == "attn":
        x = attn_mod.attn_layer(
            lp["mix"], x, positions, cfg, tp=tp[0],
            impl="chunked" if impl == "chunked" else "direct")
    elif mix == "mla":
        x = mla_mod.mla_layer(lp["mix"], x, positions, cfg, tp=tp[0])
    elif mix == "mamba":
        x = mamba_mod.mamba_layer(lp["mix"], x, cfg, impl=impl, tp=tp[0])
    else:
        x = rwkv_mod.rwkv6_layer(lp["mix"], x, cfg, impl=impl, tp=tp[0])
    if cfg.enc_dec and enc_out is not None:
        enc_kv = attn_mod.encode_cross_kv(lp["cross"], enc_out, cfg)
        x = attn_mod.cross_attn_layer(lp["cross"], x, enc_kv, cfg, tp[0])
    return _ffn_aux(lp, x, cfg, i, moe_groups, tp[1], dp)


def forward_hidden(params, cfg: ModelConfig, x: torch.Tensor, *,
                   impl: str = "chunked", enc_out: torch.Tensor | None = None,
                   remat: bool = True, moe_groups: int = 1, layout=None):
    """x: (B, S, D) embedded inputs → (hidden (B, S, D), aux loss).

    Attention layers run ``chunked_attention`` when ``impl ==
    "chunked"`` and ``direct_attention`` otherwise; Mamba and RWKV-6
    layers scan with ``impl`` (:data:`IMPLS`).  An encoder-decoder
    model's layers cross-attend ``enc_out`` (:func:`encode`).  With
    ``remat`` each body block (``period`` layers of
    ``cfg.segmentation()``) is checkpointed; the prefix layers never are.
    MoE layers route in ``moe_groups`` groups.

    With a ``layout`` (``distributed.parallel.Layout``) ``params`` are
    this rank's blocks and x its rows: each layer gathers its leaves
    just in time (inside the checkpointed block, so the recompute gathers
    again), the mixers that split over ``model`` and the dense FFN run
    tensor-parallel and MoE layers expert-parallel, and the aux loss is
    this rank's share."""
    check_supported(cfg)
    _check_impl(impl)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = dict(impl=impl, enc_out=enc_out, moe_groups=moe_groups,
              dp=layout.dp if layout is not None else None)
    prefix, period = cfg.segmentation()

    def layer(lp, where, i, x):
        tp = (None, None)
        if layout is not None:
            lp, *tp = layout.layer(lp, where, i)
        return _apply_layer(lp, x, positions, cfg, i, tp=tuple(tp), **kw)

    for i in range(prefix):
        x, a = layer(params["prefix"][i], ("prefix", i), i, x)
        aux = aux + a

    def block(b, x, aux):
        for j in range(period):
            x, a = layer(params["body"][j][b], ("body", j, b),
                         prefix + b * period + j, x)
            aux = aux + a
        return x, aux

    for b in range(len(params["body"][0]) if period else 0):
        if remat:
            x, aux = checkpointed(block, b, x, aux)
        else:
            x, aux = block(b, x, aux)
    return x, aux


def _loss_chunk(table, hk, lk):
    """Summed NLL and count of one loss chunk: hk (B, chunk, D) normed
    hidden, lk (B, chunk) labels."""
    logits = unembed(hk, table)                             # (B, chunk, V)
    mask = lk != -100
    lab = torch.where(mask, lk, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lab[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def _loss_chunk_vp(mesh, vocab, table, hk, lk):
    """:func:`_loss_chunk` over this rank's vocabulary rows of the table:
    the NLL through ``collectives.vocab_parallel_nll``."""
    from repro_torch.distributed import collectives as coll
    logits = unembed(hk, table)                            # (B, chunk, Vl)
    mask = lk != -100
    nll = coll.vocab_parallel_nll(logits, torch.where(mask, lk, 0),
                                  mesh=mesh, vocab=vocab)
    return (nll * mask).sum(), mask.sum()


def chunked_loss(params, cfg: ModelConfig, hidden: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512, *,
                 layout=None) -> torch.Tensor:
    """Mean cross-entropy over labels != -100, without materialising the
    (B, S, V) logits at once: each chunk is checkpointed, so the backward
    recomputes its logits too.

    With a ``layout`` these are this rank's rows and the table its
    vocabulary rows: the loss is vocab-parallel over ``model``, and the
    rank's summed NLL is divided by the label count of the whole batch
    (a SUM over the data dims), so the ranks' losses sum to the
    reference's mean."""
    B, S, D = hidden.shape
    h = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    table = _unembed_table(params, cfg)
    while S % chunk:
        chunk //= 2
    step = _loss_chunk
    if layout is not None and layout.tp is not None:
        h = layout.tp.copy_in(h)
        step = functools.partial(_loss_chunk_vp, layout.mesh, layout.vocab)
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, S, chunk):
        n, c = checkpointed(step, table, h[:, c0:c0 + chunk],
                            labels[:, c0:c0 + chunk])
        nll = nll + n
        cnt = cnt + c
    if layout is not None:
        cnt = layout.dp.sum(cnt.detach().to(torch.int32))
    return nll / cnt.clamp(min=1)


def loss_fn(params, cfg: ModelConfig, batch: dict, *,
            impl: str = "chunked", remat: bool = True,
            moe_groups: int = 1, mesh=None, layout=None) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S) [, patches (B, P, D), frames
    (B, enc_len, D)] → LM loss plus the MoE aux loss.  The vision prefix
    positions carry no loss.  ``remat`` and ``moe_groups`` go to
    :func:`forward_hidden`; on a ``mesh`` the embedding is the
    vocab-parallel one (:func:`embed_inputs`).

    With a ``layout`` (``distributed.parallel.Layout``; training on a
    mesh) ``params`` are this rank's blocks and ``batch`` its rows, and
    the result is this rank's share: the SUM over the data ranks is the
    reference's loss of the whole batch (:func:`chunked_loss`), and so
    is the SUM of the ranks' gradients."""
    if layout is not None:
        mesh = layout.mesh
        params = layout.top(params)
    enc_out = (encode(params, cfg, batch["frames"], layout) if cfg.enc_dec
               else None)
    x = embed_inputs(params, cfg, batch["tokens"], batch.get("patches"),
                     mesh=mesh, layout=layout)
    hidden, aux = forward_hidden(params, cfg, x, impl=impl, enc_out=enc_out,
                                 remat=remat, moe_groups=moe_groups,
                                 layout=layout)
    labels = batch["labels"]
    if cfg.frontend == "vision" and "patches" in batch:
        pad = torch.full((labels.shape[0], batch["patches"].shape[1]), -100,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return chunked_loss(params, cfg, hidden, labels, layout=layout) + aux
