"""Eager counterpart of GSPMD for the training step on a device mesh.

The reference trains on a mesh by jitting its single-device step under
``param_specs`` and ``batch_specs``: GSPMD inserts the gathers and
reductions, and the numbers stay those of the single-device step.  The
port runs one process per mesh member, each holding its blocks of the
parameters (``sharding.shard_params``) and its rows of each microbatch,
and :class:`Layout` puts in what GSPMD would:

* **FSDP over the data dims.**  A block (prefix layer, body layer, the
  loss's table) gathers the leaves the rules split over ``data`` just in
  time (``collectives.gather``: ``all_gather_into_tensor``) and drops them
  after it; under remat the recompute gathers again.  The gather's
  backward is the gradient's reduce-to-shard: a ``reduce_scatter_tensor``
  over the data dims.  A leaf the rules replicate over the data dims has
  its gradient summed over them after the backward
  (:meth:`Layout.reduce_replicated`, one ``all_reduce`` of them all).
* **Tensor parallel over ``model``.**  Attention (``wq``, ``wk``, ``wv``,
  ``wo``) and the dense FFN (``w_gate``, ``w_up``, ``w_down``) keep the
  rank's columns or rows (Megatron): the block's input passes "copy to
  model", its row-parallel output "reduce from model"; attention runs on
  the rank's ``H/|model|`` query and ``KV/|model|`` KV heads (column
  blocks are head-major, so query head h keeps KV head h // G), and the
  replicated biases ``bq``/``bk``/``bv`` are cut to those heads.  Where
  ``H`` or ``KV`` does not split over ``model`` the attention leaves are
  gathered whole instead.  The vocabulary stays split: the lookup and the
  loss are vocab-parallel (``collectives.vocab_parallel_embed``,
  ``vocab_parallel_nll``).
* **Expert parallel over ``model``.**  An MoE layer keeps the rank's
  ``E/|model|`` experts of ``w_gate``, ``w_up`` and ``w_down`` and its
  column and row blocks of the shared experts (``sharding.EXPERT_DIMS``),
  gathered over the data dims only, and computes only those
  (``models/moe.py``: every rank routes the whole group, the partial
  outputs are summed over ``model``); the router is gathered whole.
  Where ``E`` or the shared width does not split over ``model``
  (``sharding.expert_parallel``) the experts are gathered whole and run
  whole on every rank.  Every other leaf the rules put on ``model`` (the
  Mamba, RWKV-6 and MLA projections, the frontends) is gathered whole
  just in time: those layers run whole on every rank.
* **Data parallel.**  The rank runs its rows; the loss is normalised by
  the label count of the *global* microbatch, and MoE layers route the
  reference's groups of the global token stream (``models/moe.py``), so
  the SUM over the data ranks of their losses and gradients is the
  reference's.  Across ``model`` the ranks hold the same activations and
  the same gradients of what they share: nothing is summed over it.

Every rank of a group issues the same collectives in the same order, in
forward, in the remat recompute and in backward.
"""

from __future__ import annotations

import torch

from repro_torch.bridge import map_leaves, tree_map
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (EXPERT_DIMS, P, dp_axes,
                                              expert_parallel, spec_axes)
from repro_torch.launch.mesh import axis_sizes

#: attention leaves kept tensor-parallel (columns, then ``wo``'s rows)
TP_ATTN = ("wq", "wk", "wv", "wo")
#: dense-FFN leaves kept tensor-parallel
TP_FFN = ("w_gate", "w_up", "w_down")
#: MoE leaves kept expert-parallel (the rank's experts, the shared
#: experts' columns and rows)
EP_FFN = tuple(EXPERT_DIMS)
#: replicated attention biases, cut to the rank's heads
HEAD_BIASES = ("bq", "bk", "bv")


class TensorParallel:
    """Megatron's two maps over the ``model`` dim of ``mesh``, and this
    rank's ``index`` among its ``size`` members (which also fixes an MoE
    layer's expert range: ``models/moe.py``'s ``ep``)."""

    def __init__(self, mesh, axis: str = "model"):
        self.mesh, self.axis = mesh, axis
        self.size = coll.axis_size(mesh, (axis,))
        self.index = coll.axis_index(mesh, (axis,))

    def copy_in(self, x):
        return coll.copy_to_model(x, self.mesh, self.axis)

    def reduce_out(self, x):
        return coll.reduce_from_model(x, self.mesh, self.axis)


class DataParallel:
    """The data dims of ``mesh``: this rank's index among their members,
    and the row gather MoE routing needs."""

    def __init__(self, mesh, axes):
        self.mesh, self.axes = mesh, tuple(axes)
        self.size = coll.axis_size(mesh, self.axes)
        self.index = coll.axis_index(mesh, self.axes)

    def gather_rows(self, x):
        """Every member's rows of ``x`` (each the same count), in member
        order; the backward sums the gradient over the members and keeps
        this rank's rows."""
        spec = P(self.axes, *([None] * (x.dim() - 1)))
        shape = (x.shape[0] * self.size,) + tuple(x.shape[1:])
        return coll.gather(x, spec, shape, self.mesh, self.axes, self.axes)

    def sum(self, x):
        return coll.all_reduce(x, self.mesh, self.axes) if self.size > 1 \
            else x


class Layout:
    """How this rank holds ``params`` on ``mesh`` and gathers them for
    compute.  ``specs`` and ``shapes`` are trees in the params' layout
    (``sharding.param_specs`` and the global shapes); the params the
    model functions receive are the rank's local blocks."""

    def __init__(self, cfg, mesh, specs, shapes):
        self.cfg, self.mesh = cfg, mesh
        self.specs, self.shapes = specs, shapes
        sizes = axis_sizes(mesh)
        self.dp = DataParallel(mesh, dp_axes(mesh))
        self.tp = (TensorParallel(mesh) if sizes.get("model", 1) > 1
                   else None)
        self.vocab = cfg.vocab

    # --------------------------------------------------------- leaves
    def _at(self, tree, where):
        for k in where:
            tree = tree[k]
        return tree

    def _tensor(self, where):
        """(spec of the tensor, its global shape) at ``where``."""
        spec = self._at(self.specs, where)
        in_body = where[0] == "body"
        return (P(*spec[1:]) if in_body else spec), self._at(self.shapes,
                                                             where)

    def whole(self, local, where):
        """The leaf at ``where`` whole: gathered over every mesh dim its
        spec splits, the gradient summed over the data dims."""
        spec, shape = self._tensor(where)
        return coll.gather(local, spec, shape, self.mesh, None, self.dp.axes)

    def data_whole(self, local, where):
        """The leaf gathered over the data dims only (its ``model`` block
        kept)."""
        spec, shape = self._tensor(where)
        return coll.gather(local, spec, shape, self.mesh, self.dp.axes,
                           self.dp.axes)

    def whole_tree(self, tree, where):
        """:meth:`whole` over a subtree (its leaves' paths under
        ``where``)."""
        if isinstance(tree, dict):
            return {k: self.whole_tree(v, where + (k,))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.whole_tree(v, where + (i,))
                              for i, v in enumerate(tree))
        return self.whole(tree, where)

    # ---------------------------------------------------------- blocks
    def attn_tp(self) -> bool:
        """Attention runs tensor-parallel: ``H`` and ``KV`` split evenly
        over ``model``."""
        c = self.cfg
        return (self.tp is not None and c.n_heads % self.tp.size == 0
                and c.n_kv_heads % self.tp.size == 0)

    def layer(self, lp: dict, where: tuple, i: int):
        """Layer ``i``'s compute params from its local blocks ``lp`` (at
        ``where`` in the params tree) → (params, tp of the mixer, tp of
        the FFN), a tp None where that part runs whole; an MoE layer's
        FFN tp is its expert-parallel map (``moe_mix``'s ``ep``)."""
        mix, ffn = self.cfg.layer_sig(i)
        tp_mix = self.tp if (mix == "attn" and self.attn_tp()) else None
        tp_ffn = self.tp if (ffn == "dense" or (
            self.tp is not None and expert_parallel(self.cfg, self.tp.size))
        ) else None
        out = {}
        for part, sub in lp.items():
            tp = {"mix": tp_mix, "ffn": tp_ffn}.get(part)
            keep = {"mix": TP_ATTN,
                    "ffn": TP_FFN if ffn == "dense" else EP_FFN}.get(part, ())
            out[part] = {}
            for name, t in sub.items():
                at = where + (part, name)
                if tp is not None and name in keep:
                    out[part][name] = self.data_whole(t, at)
                elif tp is not None and name in HEAD_BIASES:
                    out[part][name] = self._head_slice(t, name)
                else:
                    out[part][name] = self.whole(t, at)
        return out, tp_mix, tp_ffn

    def _head_slice(self, bias, name):
        """The rank's heads of a replicated bias; its gradient comes back
        whole on every rank (a SUM over ``model`` of the ranks' slices)."""
        c, tp = self.cfg, self.tp
        heads = c.n_heads if name == "bq" else c.n_kv_heads
        width = heads // tp.size * c.head_dim
        return tp.copy_in(bias)[tp.index * width:(tp.index + 1) * width]

    def top(self, params: dict) -> dict:
        """The params outside the layer stacks for compute: ``embed`` /
        ``unembed`` as this rank's vocabulary rows gathered over the data
        dims, the encoder and every other leaf whole; ``prefix`` and
        ``body`` stay local (:meth:`layer` gathers them block by
        block)."""
        out = {}
        for k, v in params.items():
            if k in ("prefix", "body"):
                out[k] = v
            elif k in ("embed", "unembed"):
                out[k] = self.data_whole(v, (k,))
            else:
                out[k] = self.whole_tree(v, (k,))
        return out

    # ------------------------------------------------------- gradients
    def reduce_replicated(self, grads):
        """Sum over the data dims, in place, the gradients of the leaves
        whose spec does not split them over a data dim (theirs came from
        this rank's rows only): one ``all_reduce`` of a flat buffer of
        them all.  The gathered leaves were reduced by their gathers'
        backward."""
        if self.dp.size == 1:
            return grads
        dp = set(self.dp.axes)
        picked = []

        def pick(key, block, g, spec):
            if not dp & {a for e in spec for a in spec_axes(e)}:
                picked.append(g)
        map_leaves(pick, grads, self.specs)
        if picked:
            flat = self.dp.sum(torch.cat([g.reshape(-1).float()
                                          for g in picked]))
            off = 0
            for g in picked:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
        return grads


def shapes_of(params):
    """The global shape of each tensor (a DTensor's, or a tensor's own)."""
    return tree_map(lambda t: tuple(t.shape), params)
