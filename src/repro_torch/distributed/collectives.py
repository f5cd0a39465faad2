"""SP collectives: distributed flash-decode over the sharded FPR pool.

Counterpart of ``repro.distributed.collectives`` over ``torch.distributed``.
Decode shards the **physical block pool** (the N dimension) over mesh dims
rather than KV heads:

    pool partition p = (batch_shard · n_seq + seq_shard)     (row-major)
    data shards own their batch rows' blocks; model shards split each
    sequence; per-shard online-softmax partials merge with the LSE combine

        m = max_s m_s   l = Σ l_s·e^{m_s−m}   acc = Σ acc_s·e^{m_s−m}

— one f32 (B, H) ``all_reduce(MAX)`` and two ``all_reduce(SUM)``s per
layer instead of gathering the pool.

SPMD form: one process is one mesh member and calls each function here
with its **own shards**, laid out as the reference's ``shard_map``
``in_specs`` lay them out:

    pool:              P(batch_axes + seq_axes) on N
    q/tables/lengths:  P(batch_axes) on B (tables also P(seq_axes) on M
                       when ``table_cols_sharded``)
    combine over       seq_axes (empty ⇒ batch-local, no collective)

and gets back its ``out_specs`` shard (its batch rows).
:func:`local_shard` cuts a rank's shard out of a whole tensor and
:func:`gather_batch` gives every rank the whole batch again, so that
replicated activations can follow.  Block tables hold *global* physical
indices; each shard subtracts its pool offset and masks rows outside its
window.  Only ``all_reduce`` (SUM and MAX) is used — the batch gather is
a SUM of disjoint rows — because gloo, the backend that puts two ranks
on one GPU, offers little else on CUDA tensors.  A tuple of mesh dims
reduces over one process group spanning them, built once per (mesh,
dims).

The training collectives (the second half of the module) serve
``distributed/parallel.py``: :func:`gather_shards` (a leaf whole from its
blocks, one ``all_gather_into_tensor``) and its transpose
:func:`reduce_to_shard` (one ``reduce_scatter_tensor``), Megatron's
:func:`copy_to_model` / :func:`reduce_from_model`, and the
vocab-parallel :func:`vocab_parallel_nll`.  gloo runs these on CUDA
tensors but refuses ``send``/``recv`` (``distributed/probe.py``).
:data:`TRAFFIC` counts every collective's calls and bytes (and, when
asked, its seconds), summed by kind and group, from which the dry
run (``launch/op_analysis.py``) sums the ring's wire bytes.
"""

from __future__ import annotations

import itertools
import math
import time

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (block_of, decode_state_specs,
                                             shard_of, spec_axes)
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.attention import NEG_INF
from repro_torch.models.layers import drop_index, drop_write

#: pool keys of the decode state (sharded over N); every other key stays
#: whole on every rank
POOL_KEYS = ("kv", "mla_c", "mla_rope")

_GROUPS: dict = {}
_RANKS: dict = {}


def axis_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def axis_index(mesh, axes) -> int:
    """This rank's row-major index over the mesh dims ``axes`` (the
    reference's ``axis_index`` folded over a tuple of axes)."""
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _group(mesh, axes):
    """The process group of this rank's members along ``axes``."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), tuple(axes))
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, axis_size(mesh, axes)).tolist()
        group, _ = dist.new_subgroups_by_enumeration(ranks)
        _GROUPS[key] = (mesh, group)        # the mesh keeps its id unique
    return _GROUPS[key][1]


def wire_factor(kind: str, n: int) -> float:
    """Bytes a member sends per payload byte in a ring over ``n``
    members, as ``repro.launch.hlo_analysis._wire_factor`` models them:
    all-reduce 2(n−1)/n, all-gather, reduce-scatter and all-to-all
    (n−1)/n, a permute (and a broadcast, modelled as one) 1."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind in ("collective-permute", "broadcast"):
        return 1.0
    return (n - 1) / n


def group_ranks(group) -> tuple:
    """The global ranks of a process group, in group order (kept per
    group)."""
    if group not in _RANKS:
        _RANKS[group] = tuple(dist.get_process_group_ranks(group))
    return _RANKS[group]


def make_groups(mesh) -> None:
    """Make the process group of every set of ``mesh``'s dims now.  A
    group's ranks come from tensor ops on the mesh's rank grid, which
    must not run inside the dry run's fake-tensor and analysis modes
    (``launch/op_analysis.py``); every rank of a real process group
    would have to call this too."""
    names = tuple(mesh.mesh_dim_names)
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(names, r):
            group_ranks(_group(mesh, axes))


class Traffic:
    """What this process's collectives moved: calls, bytes (each call's
    message: the reduced tensor, the gathered output, the scattered
    input, the broadcast tensor) and, with ``timed``, the host seconds
    inside them (the device is synchronised first, so queued compute is
    not counted).  ``groups`` sums the calls and bytes by (kind, the
    group's global ranks), kinds named as the reference's HLO names them
    (``"all-reduce"``, ``"all-gather"``, ``"reduce-scatter"``;
    ``"broadcast"``): one entry a kind and group, so it stays as small
    as the mesh's groups however long the process runs.
    :meth:`by_kind` and :attr:`wire_bytes` are summed from it."""

    def __init__(self):
        self.timed = False
        #: True while a collective runs (the backend's own tensor work,
        #: which the dry run's op counts leave out)
        self.busy = False
        self.reset()

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        #: {(kind, global ranks): [calls, bytes]}
        self.groups: dict[tuple[str, tuple], list[int]] = {}

    def run(self, fn, nbytes: int, device, kind: str, group) -> None:
        self.calls += 1
        self.bytes += nbytes
        entry = self.groups.setdefault((kind, group_ranks(group)), [0, 0])
        entry[0] += 1
        entry[1] += nbytes
        if self.timed and device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        self.busy = True
        try:
            fn()
        finally:
            self.busy = False
        if self.timed:
            self.seconds += time.perf_counter() - t0

    def by_kind(self) -> dict:
        """``{kind: {"calls", "bytes", "wire_bytes"}}``."""
        out: dict = {}
        for (kind, ranks), (calls, nbytes) in self.groups.items():
            k = out.setdefault(kind, {"calls": 0, "bytes": 0,
                                      "wire_bytes": 0.0})
            k["calls"] += calls
            k["bytes"] += nbytes
            k["wire_bytes"] += nbytes * wire_factor(kind, len(ranks))
        return out

    @property
    def wire_bytes(self) -> float:
        """Bytes this member sends over the ring model (:func:`wire_factor`
        of each call's kind and group size)."""
        return sum(b * wire_factor(k, len(r))
                   for (k, r), (_, b) in self.groups.items())


#: the collectives of this process (every function below reports here)
TRAFFIC = Traffic()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM):
    """In-place ``all_reduce`` of ``x`` over the mesh dims ``axes``."""
    group = _group(mesh, axes)
    TRAFFIC.run(lambda: dist.all_reduce(x, op=op, group=group), _nbytes(x),
                x.device, "all-reduce", group)
    return x


def broadcast(x: torch.Tensor, mesh, axes, src: int):
    """In-place ``broadcast`` of ``x`` from the member ``src`` (its index
    over ``axes``, :func:`axis_index`) to the others along ``axes``."""
    group = _group(mesh, axes)
    TRAFFIC.run(lambda: dist.broadcast(
        x, src=dist.get_global_rank(group, src), group=group), _nbytes(x),
        x.device, "broadcast", group)
    return x


# ------------------------------------------------------- shard in, batch out
def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a view):
    what ``shard_map`` hands its body.  Each sharded dim must split
    evenly."""
    for d, entry in enumerate(spec):
        n = axis_size(mesh, spec_axes(entry))
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"evenly over {spec_axes(entry)} ({n} shards)")
    return shard_of(x, spec, mesh)


#: recurrent-state keys split over ``model`` under a layout, and the mixer
#: family whose split (``Layout.mixer_tp``) decides it
MODEL_STATES = {"conv": "mamba", "ssm": "mamba", "rwkv_s": "rwkv6"}


def local_state(state: dict, cfg, mesh, *, batch_axes, seq_axes,
                layout=None) -> dict:
    """This rank's decode state from a whole one.

    Without ``layout`` (serving whole params on a mesh): each pool's N
    rows under ``sharding.decode_state_specs`` (copied), every other key
    (tables, lengths, recurrent and cross states) whole, as the
    activations that read them are replicated.

    With a ``layout`` (``distributed.parallel.Layout``: serving from the
    rank's blocks, the rank's batch rows) the state follows
    ``decode_state_specs``: the pools as above; the tables, lengths and
    the cross and recurrent states the rank's rows over ``batch_axes``;
    ``conv`` and ``ssm`` the rank's ``d_inner`` block and ``rwkv_s`` the
    rank's heads where that mixer splits over ``model``
    (``Layout.mixer_tp``), else whole over ``model``; each key copied.
    ``rwkv_x`` stays whole over ``model``, as the token shift reads
    every channel: the reference places it ``P(None, b, "model")``,
    which changes its placement, not its math."""
    specs = decode_state_specs(cfg, mesh, batch_axes=batch_axes,
                               seq_axes=seq_axes)
    if layout is None:
        return {k: (local_shard(v, specs[k], mesh).clone()
                    if k in POOL_KEYS else v) for k, v in state.items()}
    out = {}
    for k, v in state.items():
        spec = specs[k]
        if k not in POOL_KEYS and not (k in MODEL_STATES and
                                       layout.mixer_tp(MODEL_STATES[k])):
            spec = tuple(None if "model" in spec_axes(e) else e
                         for e in spec)
        out[k] = local_shard(v, spec, mesh).clone()
    return out


def gather_batch(x: torch.Tensor, mesh, batch_axes, batch: int):
    """Each rank's batch rows (its ``P(batch_axes)`` shard) → the whole
    (batch, ...) on every rank: a SUM of disjoint rows, exact."""
    if not batch_axes:
        return x
    out = x.new_zeros((batch,) + x.shape[1:])
    i = axis_index(mesh, batch_axes)
    out[i * x.shape[0]:(i + 1) * x.shape[0]] = x
    return all_reduce(out, mesh, batch_axes)


def _shard_offset(mesh, batch_axes, seq_axes, Nl: int) -> int:
    """Pool-row offset of this shard inside the global pool."""
    return (axis_index(mesh, batch_axes) * axis_size(mesh, seq_axes)
            + axis_index(mesh, seq_axes)) * Nl


def _localize(tables, offset: int, Nl: int):
    local = tables - offset
    return torch.where((tables >= 0) & (local >= 0) & (local < Nl), local,
                       -1)


def local_tables(tables, mesh, batch_axes, seq_axes, Nl: int):
    """Global rows of a (B, M) table → this rank's pool rows (of ``Nl``);
    rows of other shards and holes → -1, so writes through it drop."""
    return _localize(tables, _shard_offset(mesh, batch_axes, seq_axes, Nl),
                     Nl)


def _lse_combine(m, l, acc, mesh, axes):
    if not axes:
        return acc / l.clamp(min=1e-30)[..., None]
    m_g = all_reduce(m.clone(), mesh, axes, dist.ReduceOp.MAX)
    scale = torch.exp(m - m_g)
    l_g = all_reduce(l * scale, mesh, axes)
    acc_g = all_reduce(acc * scale[..., None], mesh, axes)
    return acc_g / l_g.clamp(min=1e-30)[..., None]


# ----------------------------------------------------------- local partials
def _chunks(tables, row_bytes: int, chunk_bytes: int):
    """Yield (column offset, (B, bpc) table chunk) with the table padded
    by -1 to whole chunks of ~``chunk_bytes`` gathered rows."""
    M = tables.shape[1]
    bpc = max(1, min(M, chunk_bytes // max(1, row_bytes)))
    padM = (-M) % bpc
    if padM:
        tables = torch.nn.functional.pad(tables, (0, padM), value=-1)
    for c0 in range(0, tables.shape[1], bpc):
        yield c0, tables[:, c0:c0 + bpc]


def _paged_partials(q, k_pool, v_pool, tables, lengths, *,
                    window: int | None, chunk_bytes: int = 1 << 27,
                    pos_base: int = 0):
    """Un-normalised attention over one pool shard, chunked over the block
    table so the gathered KV copy never exceeds ~``chunk_bytes``.

    q: (B, KV, G, hd) f32; pools: (Nl, bs, KV, hd); tables: (B, M) *local*
    physical indices (<0 ⇒ not this shard / hole).  Returns m, l
    (B, KV, G), acc (B, KV, G, hd).
    """
    B, KV, G, hd = q.shape
    Nl, bs = k_pool.shape[:2]
    m = q.new_full((B, KV, G), NEG_INF)
    l = q.new_zeros((B, KV, G))
    acc = q.new_zeros((B, KV, G, hd))
    row_bytes = B * bs * KV * hd * k_pool.element_size()
    for c0, tb in _chunks(tables, row_bytes, chunk_bytes):
        n = tb.shape[1] * bs
        tclamp = tb.clamp(0, Nl - 1).long()
        k = k_pool[tclamp].reshape(B, n, KV, hd).float()
        v = v_pool[tclamp].reshape(B, n, KV, hd).float()
        s = torch.einsum("bkgd,bskd->bkgs", q, k) * (hd ** -0.5)
        pos = (pos_base + c0 * bs
               + torch.arange(n, device=q.device))[None, :]
        valid = (pos < lengths[:, None]) & (tb >= 0).repeat_interleave(
            bs, dim=1)
        if window is not None:
            valid &= pos > lengths[:, None] - 1 - window
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * valid[:, None, None, :]
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bkgs,bskd->bkgd", p, v)
        m = m_new
    return m, l, acc


# --------------------------------------------------- vocab-parallel embed
class _SumOverRanks(torch.autograd.Function):
    """SUM over a process group forward; backward the identity on this
    rank's shard (the output is replicated, so each rank's cotangent is
    already the whole one: the transpose of the reference's psum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def vocab_shard(table: torch.Tensor, mesh, axis: str = "model"):
    """This rank's rows of a whole (V, D) table under ``P(axis, None)``: a
    view of rows ``[i·Vl, (i+1)·Vl)`` with ``Vl = ceil(V / n)``, the last
    shard short where the reference pads the table."""
    return shard_of(table, (axis,), mesh)


def vocab_parallel_embed(tokens, table, *, mesh, vocab: int,
                         axis: str = "model"):
    """Embedding lookup with the table V-sharded over ``axis``: one masked
    local gather + one SUM over ``axis``

        x = Σ_axis( mask·table_local[tokens − offset] )

    tokens: this rank's (B, S) or (B,) ids (whatever batch rows it
    holds: the reference's ``dp_spec`` picks them); table: this rank's
    rows of the (vocab, D) table (:func:`vocab_shard`; rows ``[i·Vl,
    i·Vl + len)``, ``Vl = ceil(vocab / n)``).  Differentiable in
    ``table``.
    """
    Vl = -(-vocab // axis_size(mesh, (axis,)))
    loc = tokens.long() - axis_index(mesh, (axis,)) * Vl
    ok = (loc >= 0) & (loc < table.shape[0])
    x = table[loc.clamp(0, max(table.shape[0] - 1, 0))]
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return _SumOverRanks.apply(x, mesh, (axis,))


# --------------------------------------------------- SP prefill cache write
def scatter_seq_sp(pool, seq, tab, *, mesh, batch_axes=("data",),
                   seq_axes=("model",)):
    """Write prefill cache rows into this rank's pool shard, in place.
    Each shard localises the row indices to its own pool window and drops
    the rest (holes too) with a write of fixed length
    (``layers.drop_write``).

    pool: (Nl, bs, …) this rank's P(ba+sa) rows; seq: (R, bs, …) the
    rank's rows (P(ba)); tab: (R,) their global physical rows.
    """
    Nl = pool.shape[0]
    loc = tab.long() - _shard_offset(mesh, tuple(batch_axes),
                                     tuple(seq_axes), Nl)
    return drop_write(pool, drop_index(
        (loc,), (tab >= 0) & (loc >= 0) & (loc < Nl)), seq)


# ------------------------------------------------------------- GQA SP decode
def paged_decode_attention_sp(q, k_pool, v_pool, tables, lengths, *, mesh,
                              batch_axes=("data",), seq_axes=("model",),
                              window: int | None = None,
                              table_cols_sharded: bool = False):
    """SP decode attention on this rank's shards; same contract as
    ``models.attention.paged_decode_attention_ref`` for its batch rows.

    q: (Bl, H, hd); pools: (Nl, bs, KV, hd); tables: (Bl, M) global
    indices, or (Bl, M / n_seq) — this rank's columns — with
    ``table_cols_sharded``; lengths: (Bl,) → (Bl, H, hd).

    ``table_cols_sharded`` (``"sp_opt"``): with the identity block layout
    (column m lives on seq shard m // M_loc) each shard walks only its own
    table columns instead of masking through all of them.
    """
    Bl, H, hd = q.shape
    Nl, bs, KV, _ = k_pool.shape
    ba, sa = tuple(batch_axes), tuple(seq_axes)
    pos_base = (axis_index(mesh, sa) * tables.shape[1] * bs
                if table_cols_sharded else 0)
    m, l, acc = _paged_partials(
        q.float().reshape(Bl, KV, H // KV, hd), k_pool, v_pool,
        _localize(tables, _shard_offset(mesh, ba, sa, Nl), Nl),
        lengths, window=window, pos_base=pos_base)
    out = _lse_combine(m, l, acc, mesh, sa)
    return out.reshape(Bl, H, hd).to(q.dtype)


# ------------------------------------------------------------- MLA SP decode
def mla_ctx_sp(q_lat, q_rope, c_pool, rope_pool, tables, lengths, *, scale,
               mesh, batch_axes=("data",), seq_axes=("model",),
               table_cols_sharded: bool = False):
    """The SP latent context of the absorbed-MLA decode on this rank's
    shards, the contract of the MLA kernel: q_lat (Bl, H, rank) and
    q_rope (Bl, H, rope_hd) f32, pools (Nl, bs, rank) / (Nl, bs,
    rope_hd), tables and lengths as in :func:`paged_decode_attention_sp`
    → softmax-weighted latents (Bl, H, rank) f32 (0 for a slot that sees
    nothing)."""
    ba, sa = tuple(batch_axes), tuple(seq_axes)
    Nl, bs, rank = c_pool.shape
    Bl, H = q_lat.shape[:2]
    pos_base = (axis_index(mesh, sa) * tables.shape[1] * bs
                if table_cols_sharded else 0)
    local = _localize(tables, _shard_offset(mesh, ba, sa, Nl), Nl)
    mx = q_lat.new_full((Bl, H), NEG_INF)
    l = q_lat.new_zeros((Bl, H))
    acc = q_lat.new_zeros((Bl, H, rank))
    row_bytes = Bl * bs * rank * c_pool.element_size()
    for c0, tb in _chunks(local, row_bytes, 1 << 27):
        n = tb.shape[1] * bs
        tclamp = tb.clamp(0, Nl - 1).long()
        c = c_pool[tclamp].reshape(Bl, n, rank).float()
        kr = rope_pool[tclamp].reshape(Bl, n, -1).float()
        s = (torch.einsum("bhr,bsr->bhs", q_lat, c)
             + torch.einsum("bhr,bsr->bhs", q_rope, kr)) * scale
        pos = (pos_base + c0 * bs
               + torch.arange(n, device=q_lat.device))[None, :]
        valid = (pos < lengths[:, None]) & (tb >= 0).repeat_interleave(
            bs, dim=1)
        s = torch.where(valid[:, None, :], s, NEG_INF)
        m_new = torch.maximum(mx, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * valid[:, None, :]
        sc = torch.exp(mx - m_new)
        l = l * sc + p.sum(dim=-1)
        acc = acc * sc[..., None] + torch.einsum("bhs,bsr->bhr", p, c)
        mx = m_new
    return _lse_combine(mx, l, acc, mesh, sa)


def mla_decode_sp(params, x, positions, c_pool, rope_pool, tables, lengths,
                  cfg, *, mesh, batch_axes=("data",), seq_axes=("model",),
                  table_cols_sharded: bool = False, tp=None):
    """SP absorbed-MLA decode on this rank's shards; same contract as
    ``models.mla.mla_decode_ref`` for its batch rows: x (Bl, D),
    positions (Bl,), pools (Nl, bs, rank) / (Nl, bs, rope_hd), tables and
    lengths as in :func:`paged_decode_attention_sp` → (Bl, D).

    Under ``tp`` (``distributed.parallel.TensorParallel``: ``wq_b`` and
    ``wkv_b`` hold the rank's heads' columns, ``wo`` their rows) the
    rank's heads' absorbed queries are all-gathered over ``model``, as
    the context takes every head; the context's rank heads then meet the
    rank's ``W_UV`` and ``wo`` rows, summed by ``tp.reduce_product``."""
    from repro_torch.models.mla import absorbed_query, mla_out

    m_ = cfg.mla
    q_lat, q_rope, w_uv = absorbed_query(params, x, positions, cfg, tp)
    if tp is not None:
        q_lat, q_rope = tp.gather(q_lat, 1), tp.gather(q_rope, 1)
    ctx = mla_ctx_sp(q_lat, q_rope, c_pool, rope_pool, tables, lengths,
                     scale=(m_.nope_head_dim + m_.rope_head_dim) ** -0.5,
                     mesh=mesh, batch_axes=batch_axes, seq_axes=seq_axes,
                     table_cols_sharded=table_cols_sharded)
    if tp is not None:
        ctx = tp.cut(ctx, 1)
    return mla_out(params, x, ctx, w_uv, tp)


# ==================================================== training collectives
def _coordinates(mesh, axes, p: int) -> dict:
    """{dim: index} of the member at row-major position ``p`` over
    ``axes`` (the inverse of :func:`axis_index`)."""
    sizes = axis_sizes(mesh)
    out = {}
    for a in reversed(tuple(axes)):
        p, out[a] = divmod(p, sizes[a])
    return out


def split_axes(spec) -> tuple:
    """Every mesh dim that ``spec`` splits a tensor dim over."""
    return tuple(a for e in spec for a in spec_axes(e))


def _axes_of(spec, axes, mesh) -> tuple:
    """The dims of ``axes`` (in their order) that ``spec`` splits and
    that have more than one member."""
    used = {a for e in spec for a in spec_axes(e)}
    sizes = axis_sizes(mesh)
    return tuple(a for a in axes if a in used and sizes[a] > 1)


def _padded(x: torch.Tensor, shape) -> torch.Tensor:
    if tuple(x.shape) == tuple(shape):
        return x
    out = x.new_zeros(shape)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def _chunk_shape(shape, spec, mesh, axes) -> tuple:
    """The largest block over ``axes`` (the first one's)."""
    first = block_of(shape, spec, mesh, {a: 0 for a in axes}, axes)
    return tuple(s.stop - s.start for s in first)


def _block_layout(shape, spec, mesh, axes):
    """How the members' blocks of a tensor of ``shape`` (split by
    ``spec``) lie in the buffer a collective over ``axes`` moves: every
    block padded to the first, the largest, the members row-major over
    ``axes``.  Returns (the padded whole's shape with each split dim
    unfolded into its members and the block, the permutation of it that
    puts the members first and then the block's dims, the padded
    whole's shape, {dim: the positions of its entries along the padded
    dim} for each dim that splits unevenly)."""
    sizes = axis_sizes(mesh)
    chunk = _chunk_shape(shape, spec, mesh, axes)
    unfolded, pos, padded, real = [], {}, [], {}
    for d, n in enumerate(shape):
        split = tuple(a for a in (spec_axes(spec[d]) if d < len(spec)
                                  else ()) if a in axes)
        for a in split:
            pos[a] = len(unfolded)
            unfolded.append(sizes[a])
        pos[d] = len(unfolded)
        unfolded.append(chunk[d])
        parts = math.prod(sizes[a] for a in split)
        padded.append(parts * chunk[d])
        if padded[d] != n:
            blocks = (block_of((n,), (spec[d],), mesh,
                               _coordinates(mesh, split, p), split)[0]
                      for p in range(parts))
            real[d] = [p * chunk[d] + i for p, blk in enumerate(blocks)
                       for i in range(blk.stop - blk.start)]
    perm = [pos[a] for a in axes] + [pos[d] for d in range(len(shape))]
    return unfolded, perm, padded, real


def gather_shards(local: torch.Tensor, spec, shape, mesh, axes=None):
    """The tensor of global ``shape`` whole along the dims that ``spec``
    splits over the mesh dims ``axes`` (default: all of its dims), from
    each member's block ``local``: one ``all_gather_into_tensor`` over
    the members along ``axes``, blocks padded to the largest, then one
    copy puts every block in place (and one ``index_select`` a dim drops
    the padding of a dim that splits unevenly).  Dims split over other
    mesh dims keep this rank's block."""
    axes = _axes_of(spec, axes if axes is not None else axis_sizes(mesh),
                    mesh)
    if not axes:
        return local
    part = [n if _axes_of((spec[d] if d < len(spec) else None,), axes, mesh)
            else local.shape[d] for d, n in enumerate(shape)]
    chunk = _chunk_shape(part, spec, mesh, axes)
    n = axis_size(mesh, axes)
    # gloo wants the members' blocks stacked along dim 0: (n·c0, c1, ...)
    out = local.new_empty((n * chunk[0],) + chunk[1:])
    src = _padded(local.contiguous(), chunk)
    group = _group(mesh, axes)
    TRAFFIC.run(lambda: dist.all_gather_into_tensor(out, src, group=group),
                _nbytes(out), local.device, "all-gather", group)
    unfolded, perm, padded, real = _block_layout(part, spec, mesh, axes)
    whole = out.view([unfolded[i] for i in perm]).permute(
        [perm.index(i) for i in range(len(perm))]).reshape(padded)
    for d, idx in real.items():
        whole = whole.index_select(d, torch.tensor(idx, device=out.device))
    return whole


def reduce_to_shard(whole: torch.Tensor, spec, mesh, axes=None,
                    sum_axes=()):
    """The transpose of :func:`gather_shards`: this rank's block of
    ``whole`` (whole along the dims ``spec`` splits over ``axes``),
    summed over the members along ``sum_axes`` (a subset of ``axes``:
    the data dims, whose members computed from other rows) with one
    ``reduce_scatter_tensor``; along the other dims of ``axes`` every
    member holds the same values, so the rank only keeps its block."""
    axes = _axes_of(spec, axes if axes is not None else axis_sizes(mesh),
                    mesh)
    sum_axes = _axes_of(spec, sum_axes, mesh)
    keep = tuple(a for a in axes if a not in sum_axes)
    if keep:
        coord = {a: mesh.get_local_rank(a) for a in keep}
        whole = whole[block_of(whole.shape, spec, mesh, coord, keep)]
    if not sum_axes:
        return whole.clone()
    shape = tuple(whole.shape)
    chunk = _chunk_shape(shape, spec, mesh, sum_axes)
    n = axis_size(mesh, sum_axes)
    unfolded, perm, padded, real = _block_layout(shape, spec, mesh,
                                                 sum_axes)
    for d, idx in real.items():     # pad each block to the largest
        grown = list(whole.shape)
        grown[d] = padded[d]
        whole = whole.new_zeros(grown).index_copy_(
            d, torch.tensor(idx, device=whole.device), whole)
    src = whole.reshape(unfolded).permute(perm).reshape(
        (n * chunk[0],) + chunk[1:])
    out = whole.new_empty(chunk)
    group = _group(mesh, sum_axes)
    TRAFFIC.run(lambda: dist.reduce_scatter_tensor(out, src, group=group),
                _nbytes(src), whole.device, "reduce-scatter", group)
    mine = block_of(shape, spec, mesh, {
        a: mesh.get_local_rank(a) for a in sum_axes}, sum_axes)
    return out[tuple(slice(0, s.stop - s.start) for s in mine)]


class _Gather(torch.autograd.Function):
    """:func:`gather_shards` forward, :func:`reduce_to_shard` backward:
    a block gathered just in time for compute, whose gradient comes back
    summed over the data dims and cut to the block."""

    @staticmethod
    def forward(ctx, local, spec, shape, mesh, axes, sum_axes):
        ctx.args = (spec, mesh, axes, sum_axes)
        return gather_shards(local, spec, shape, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        spec, mesh, axes, sum_axes = ctx.args
        return (reduce_to_shard(g.contiguous(), spec, mesh, axes, sum_axes),
                None, None, None, None, None)


def gather(local, spec, shape, mesh, axes=None, sum_axes=()):
    """Differentiable :func:`gather_shards` (the backward is
    :func:`reduce_to_shard` with ``sum_axes``)."""
    axes = _axes_of(spec, axes if axes is not None else axis_sizes(mesh),
                    mesh)
    if not axes:
        return local
    return _Gather.apply(local, spec, tuple(shape), mesh, axes,
                         tuple(sum_axes))


class _CopyToRanks(torch.autograd.Function):
    """Identity forward; SUM over a process group backward: Megatron's
    "copy to model" at the input of a column-parallel product, whose
    ranks each return the input's gradient through their own columns."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), *ctx.args), None, None


def copy_to_model(x, mesh, axis: str = "model"):
    """Megatron's "copy to model": identity forward, SUM over ``axis``
    backward."""
    return _CopyToRanks.apply(x, mesh, (axis,))


def reduce_from_model(x, mesh, axis: str = "model"):
    """Megatron's "reduce from model": SUM over ``axis`` forward (the
    partial products of a row-parallel product), identity backward."""
    return _SumOverRanks.apply(x, mesh, (axis,))


class _VocabParallelNLL(torch.autograd.Function):
    """−log softmax at the gold label, with the vocabulary split over a
    mesh dim: ``logits`` are this rank's (..., Vl) columns starting at
    ``offset``.  logsumexp through a MAX and a SUM over the ranks, the
    gold logit through a masked SUM (one SUM carries both); backward
    ``softmax − onehot`` on the rank's columns, no collective."""

    @staticmethod
    def forward(ctx, logits, labels, offset, mesh, axes):
        m = all_reduce(logits.amax(dim=-1), mesh, axes, dist.ReduceOp.MAX)
        loc = labels.long() - offset
        mine = (loc >= 0) & (loc < logits.shape[-1])
        gold = torch.where(mine, logits.gather(
            -1, loc.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0], 0.0)
        sums = all_reduce(torch.stack(
            [torch.exp(logits - m[..., None]).sum(-1), gold]), mesh, axes)
        logz = m + torch.log(sums[0])
        ctx.save_for_backward(logits, logz, loc, mine)
        return logz - sums[1]

    @staticmethod
    def backward(ctx, g):
        logits, logz, loc, mine = ctx.saved_tensors
        d = torch.exp(logits - logz[..., None])
        d.scatter_add_(-1, loc.clamp(0, logits.shape[-1] - 1)[..., None],
                       -mine[..., None].to(d.dtype))
        return d * g[..., None], None, None, None, None


def vocab_parallel_nll(logits, labels, *, mesh, vocab: int,
                       axis: str = "model"):
    """Per-token NLL (the labels' shape) from this rank's vocabulary
    columns of the logits (rows ``[i·Vl, i·Vl + len)`` of the table,
    ``Vl = ceil(vocab / n)``: :func:`vocab_shard`).  Labels outside the
    vocabulary (the caller masks them) give logsumexp alone."""
    Vl = -(-vocab // axis_size(mesh, (axis,)))
    return _VocabParallelNLL.apply(logits, labels,
                                   axis_index(mesh, (axis,)) * Vl, mesh,
                                   (axis,))
