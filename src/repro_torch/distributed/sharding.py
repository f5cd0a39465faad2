"""Sharding rules: DP / FSDP / TP / EP / SP specs for every tree we ship.

Counterpart of ``repro.distributed.sharding``, rule for rule.  Axis
convention (``launch/mesh.py``):

    single-pod : mesh (16, 16)      dims ("data", "model")
    multi-pod  : mesh (2, 16, 16)   dims ("pod", "data", "model")

* ``model``            — tensor parallel (Megatron column/row) + expert
                         parallel (MoE expert dim) + KV-head parallel.
* ``data`` (+ ``pod``) — data parallel for activations, FSDP/ZeRO for
                         parameters and optimiser state.
* serving decode       — KV pools shard their block (sequence) dimension
                         over ``batch_axes + seq_axes``
                         (``distributed/collectives.py``).

A spec is a :class:`P`: a tuple with one entry per tensor dim, each
``None``, a mesh-dim name, or a tuple of names — the contents of the
reference's ``PartitionSpec``, so the two compare entry by entry.
:func:`to_placements` turns one into DTensor placements, one per mesh
dim.  Rules go by leaf *path*: the port's params tree is walked with
``bridge.map_leaves``, which names each tensor by its reference key
(``body/0/mix/wq``), so a body leaf gets the reference's leading
``None`` for its scan stack.  The specs of body leaves are therefore
those of the reference's stacked leaves; a body block's own tensor takes
``spec[1:]``.

Serving places its state by these rules (the KV pools over N, and
under a ``Layout`` the batch rows and recurrent shares of
:func:`decode_state_specs`: ``collectives.local_state``).  It serves
either from this rank's blocks under :func:`param_specs`, as training
holds them, or from whole weights with the MoE experts cut to the
rank's ``model`` block (:func:`expert_shards` cuts the blocks once, or
compute views them in whole stacks).  Training holds its parameters,
AdamW moments and error state sharded: :func:`shard_params` makes each
tensor a DTensor of this rank's block under :func:`param_specs` (split
as DTensor splits, uneven dims with a short last block:
:func:`block_of`), and compute reads the local blocks
(:func:`local_blocks`, ``distributed/parallel.py``).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.bridge import map_leaves, tree_map
from repro_torch.launch.mesh import axis_sizes


def _entry(entry):
    """One spec entry as ``PartitionSpec`` keeps it: a tuple of mesh dims,
    with () as None and a single dim as its name."""
    if entry is None or isinstance(entry, str):
        return entry
    entry = tuple(entry)
    return entry if len(entry) > 1 else (entry[0] if entry else None)


class P(tuple):
    """A partition spec: ``P("data", None)`` is the tuple ``("data",
    None)``, one entry per tensor dim, each normalised as
    ``PartitionSpec`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, map(_entry, entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spec_axes(entry) -> tuple:
    """The mesh dims of one spec entry: ``None`` → (), a name → (name,)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim that
    splits tensor dim ``d``, ``Replicate()`` elsewhere.

    A tensor dim split over several mesh dims splits row-major over them
    (partition ``p = data_idx · n_model + model_idx`` for ``("data",
    "model")``, as ``collectives._shard_offset`` assumes); DTensor applies
    nested shards of one dim in mesh-dim order, which is that order only
    when the entry lists its dims in mesh-dim order, so any other order
    is refused."""
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    used: set = set()
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in spec_axes(entry)]
        if dims != sorted(dims):
            raise ValueError(
                f"spec entry {entry!r} lists mesh dims out of the mesh's "
                f"order {tuple(names)}: DTensor would not split it "
                f"row-major")
        for i in dims:
            if i in used:
                raise ValueError(f"mesh dim {names[i]!r} used twice in "
                                 f"{spec!r}")
            used.add(i)
            out[i] = Shard(d)
    return out


# ---------------------------------------------------------------- axis sets
def dp_axes(mesh) -> tuple:
    """Data-parallel axes: ("pod","data") on multi-pod, ("data",) otherwise."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def fsdp_spec_axes(mesh):
    ax = dp_axes(mesh)
    return ax if len(ax) > 1 else (ax[0] if ax else None)


# ------------------------------------------------------------- param rules

#: column-parallel: (d_in, d_out) → (FSDP, model)
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "s_gate", "s_up", "in_proj",
        "wq_b", "wkv_b", "wr", "wg", "dt_proj"}
#: row-parallel: (d_in, d_out) → (model, FSDP)
_ROW = {"wo", "w_down", "s_down", "out_proj"}
#: FSDP-only on dim 0 (output dim small/shared): (d_in, d_out) → (FSDP, None)
_FSDP0 = {"wq_a", "wkv_a", "x_proj", "w_lora_a", "router"}
#: replicated small params
_REPL = {"norm", "q_norm", "kv_norm", "final_norm", "mu", "u", "ln_x",
         "conv_b", "D", "bq", "bk", "bv", "enc_pos", "dec_pos", "conv_w",
         "w_lora_b", "A_log"}
#: unembed (V, D) → (model, FSDP): vocab-parallel loss (logsumexp = psum)
_VOCAB = {"unembed"}
#: frontend stubs (D, D)
_FRONT = {"vision_proj", "audio_proj"}


def _leaf_spec(name: str, ndim: int, fsdp) -> P:
    if name == "embed":
        # V over model; lookups go through collectives.vocab_parallel_embed
        return P("model", None)
    if name in _VOCAB:
        return P("model", fsdp)
    if name in _FRONT:
        return P(fsdp, None)
    if name in _REPL:
        return P(*([None] * ndim))
    if name in _COL:
        if ndim == 3:                       # MoE experts (E, d_in, d_out)
            return P("model", fsdp, None)
        if ndim == 1:                       # bias of a column-parallel proj
            return P("model")
        return P(fsdp, "model")
    if name in _ROW:
        if ndim == 3:                       # MoE (E, d_in, d_out)
            return P("model", None, fsdp)
        return P("model", fsdp)
    if name in _FSDP0:
        return P(fsdp, *([None] * (ndim - 1)))
    return P(*([None] * ndim))              # safe default: replicate


def param_specs(params, mesh) -> dict:
    """A tree of :class:`P` matching the port's ``params`` (from
    ``init_params``): the reference's spec of each tensor's leaf, so a
    body block's spec carries the stack's leading ``None``."""
    fsdp = fsdp_spec_axes(mesh)

    def rule(key, block, leaf):
        names = key.split("/")
        stacked = "body" in names           # scan-stacked in the reference
        spec = _leaf_spec(names[-1], leaf.dim(), fsdp)
        return P(None, *spec) if stacked else spec

    return map_leaves(rule, params)


def param_placements(params, mesh) -> dict:
    """DTensor placements of each tensor of ``params`` (a body block's
    tensor drops its stack's leading entry)."""
    return map_leaves(
        lambda key, block, _x, spec: to_placements(
            spec if block is None else spec[1:], mesh),
        params, param_specs(params, mesh))


# ------------------------------------------------------ expert parallelism
#: the MoE leaves the ``model`` dim splits (expert parallelism), each by
#: the dim its rule splits: the expert stacks (E, d_in, d_out) on E, the
#: shared experts' gate and up on their columns, their down on its rows
EXPERT_DIMS = {"w_gate": 0, "w_up": 0, "w_down": 0, "s_gate": 1, "s_up": 1,
               "s_down": 0}


def expert_parallel(cfg, n: int) -> bool:
    """Whether MoE layers run expert-parallel over ``n`` ``model`` ranks:
    the config has MoE layers, ``n > 1``, and both the routed experts and
    the shared experts' width split evenly over the ranks (otherwise the
    experts run whole on every rank)."""
    mo = cfg.moe
    if n <= 1 or mo is None or "moe" not in cfg.ffns:
        return False
    shared = (mo.d_expert or cfg.d_ff) * mo.num_shared
    return mo.num_experts % n == 0 and shared % n == 0


def expert_block(t: torch.Tensor, name: str, cfg, n: int, i: int):
    """Block ``i`` of ``n`` of the MoE leaf ``name`` under its ``model``
    split (:data:`EXPERT_DIMS`): a view of a whole leaf, or ``t`` itself
    where it is that block already (the split dim 1/n of the whole).  Any
    other size raises."""
    d = EXPERT_DIMS[name]
    mo = cfg.moe
    whole = (mo.num_experts if name.startswith("w_")
             else (mo.d_expert or cfg.d_ff) * mo.num_shared)
    if t.shape[d] == whole:
        return t.narrow(d, i * (whole // n), whole // n)
    if t.shape[d] == whole // n:
        return t
    raise ValueError(f"MoE leaf {name} of shape {tuple(t.shape)}: dim {d} "
                     f"is neither the whole {whole} nor one of {n} blocks "
                     f"({whole // n})")


def expert_blocks(ffn: dict, cfg, n: int, i: int) -> dict:
    """An MoE layer's params with each expert leaf as block ``i`` of ``n``
    (:func:`expert_block`); the router and the norm as they are."""
    return {k: expert_block(v, k, cfg, n, i) if k in EXPERT_DIMS else v
            for k, v in ffn.items()}


def expert_shards(params, cfg, mesh, axis: str = "model") -> dict:
    """A serving rank's params with every MoE layer's experts cut to this
    rank's blocks under the reference's ``model`` split (``param_specs``:
    the expert stacks ``P("model", fsdp, None)`` and ``P("model", None,
    fsdp)``, the shared experts' columns and rows), as contiguous copies:
    the caller can drop the whole stacks.  Every other tensor is the
    caller's own.  Params of a config whose experts do not split over
    ``axis`` (:func:`expert_parallel`) come back as they are."""
    n = axis_sizes(mesh).get(axis, 1)
    if not expert_parallel(cfg, n):
        return params
    i = mesh.get_local_rank(axis)
    prefix, period = cfg.segmentation()

    def cut(lp: dict, layer: int) -> dict:
        if cfg.ffns[layer] != "moe":
            return lp
        blocks = expert_blocks(lp["ffn"], cfg, n, i)
        return dict(lp, ffn={
            k: v.clone(memory_format=torch.contiguous_format)
            if k in EXPERT_DIMS else v for k, v in blocks.items()})

    out = dict(params)
    out["prefix"] = [cut(lp, k) for k, lp in enumerate(params["prefix"])]
    out["body"] = [[cut(lp, prefix + b * period + j)
                    for b, lp in enumerate(blocks)]
                   for j, blocks in enumerate(params["body"])]
    return out


# ------------------------------------------------------------ batch specs
def batch_specs(mesh, *, has_patches=False, has_frames=False) -> dict:
    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    d = {"tokens": P(dp, None), "labels": P(dp, None)}
    if has_patches:
        d["patches"] = P(dp, None, None)
    if has_frames:
        d["frames"] = P(dp, None, None)
    return d


# --------------------------------------------------------- decode state specs
def decode_axes(mesh, *, batch: int):
    """(batch_axes, seq_axes) for the uniform decode layout.

    The pool N dim shards over batch_axes + seq_axes (row-major, matching
    transformer.sp_identity_tables); SP attention LSE-combines over
    seq_axes.  Batch absorbs the data(+pod) axes when divisible;
    otherwise (batch 1) the data axes join the sequence shards.  'model'
    always shards sequence, never KV heads.
    """
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    if batch % max(n_dp, 1) == 0 and n_dp > 1:
        return dp, ("model",)
    return (), dp + ("model",)


def decode_state_specs(cfg, mesh, *, batch_axes, seq_axes) -> dict:
    """Specs for the decode-state dict (transformer.cache_spec keys)."""
    ba = tuple(batch_axes)
    pool = ba + tuple(seq_axes)
    pool = pool if len(pool) != 1 else pool[0]
    b = ba if len(ba) != 1 else (ba[0] if ba else None)
    sp: dict[str, P] = {}
    sp["tables"] = P(b, None)
    sp["lengths"] = P(b)
    # paged pools: (L, N, bs, KV*2, hd) fused / (L, N, bs, rank)
    sp["kv"] = P(None, pool, None, None, None)
    sp["mla_c"] = P(None, pool, None, None)
    sp["mla_rope"] = P(None, pool, None, None)
    # recurrent states: (L, B, ...) — batch over ba, channels over model
    sp["conv"] = P(None, b, None, "model")
    sp["ssm"] = P(None, b, "model", None)
    sp["rwkv_x"] = P(None, b, "model")
    sp["rwkv_s"] = P(None, b, "model", None, None)
    sp["cross_k"] = P(None, b, None, None, None)
    sp["cross_v"] = P(None, b, None, None, None)
    return sp


def tokens_spec(mesh, *, shard_batch: bool = True) -> P:
    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    return P(dp if shard_batch else None)


def filter_state_specs(specs: dict, state: dict) -> dict:
    """Keep only the spec entries whose key exists in the state dict."""
    return {k: specs[k] for k in state}


# ----------------------------------------------------- sharded training state
def block_of(shape, spec, mesh, coord: dict, axes) -> tuple:
    """Slices of the block that the member at ``coord`` ({mesh dim:
    index}) holds of a tensor of ``shape`` split by ``spec`` over the
    mesh dims ``axes`` only (dims split over other mesh dims stay
    whole): each dim split row-major over its entry's dims in
    ``torch.chunk`` sizes, a short last block, as DTensor splits it."""
    sizes = axis_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        start, stop = 0, n
        for a in (spec_axes(spec[d]) if d < len(spec) else ()):
            if a not in axes:
                continue
            step = -(-(stop - start) // sizes[a])
            start, stop = (min(stop, start + coord[a] * step),
                           min(stop, start + (coord[a] + 1) * step))
        out.append(slice(start, stop))
    return tuple(out)


def shard_of(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a
    view), split as DTensor splits it: an uneven dim gives a short last
    block."""
    axes = tuple(a for e in spec for a in spec_axes(e))
    coord = {a: mesh.get_local_rank(a) for a in axes}
    return x[block_of(x.shape, spec, mesh, coord, axes)]


def _tensor_spec(spec, block):
    """A body block's tensor drops its stack's leading spec entry."""
    return spec if block is None else P(*spec[1:])


def shard_params(params, mesh, specs=None):
    """Each tensor of ``params`` (whole, on every rank) as a DTensor over
    ``mesh`` holding only this rank's block (a copy) under ``specs``
    (default :func:`param_specs`).  Built with ``DTensor.from_local``:
    every rank cuts its own block, so nothing is scattered.  Any tree in
    the params' layout will do (moments, error state)."""
    specs = specs if specs is not None else param_specs(params, mesh)

    def place(key, block, x, spec):
        spec = _tensor_spec(spec, block)
        return DTensor.from_local(
            shard_of(x, spec, mesh).clone(), mesh, to_placements(spec, mesh),
            run_check=False, shape=x.shape, stride=_contiguous(x.shape))

    return map_leaves(place, params, specs)


def _contiguous(shape) -> tuple:
    return tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))


def map_shards(fn, tree):
    """``fn`` over each tensor's local block; a DTensor comes back as a
    DTensor of the same global shape and placements, a plain tensor
    plain."""
    def one(t):
        if not isinstance(t, DTensor):
            return fn(t)
        return DTensor.from_local(fn(t.to_local()), t.device_mesh,
                                  t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return tree_map(one, tree)


def local_blocks(tree):
    """Each DTensor's local block itself (no copy: writes reach the
    DTensor); plain tensors as they are."""
    with torch.no_grad():
        return tree_map(lambda t: t.to_local() if isinstance(t, DTensor)
                        else t, tree)
