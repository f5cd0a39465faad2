"""Eager counterpart of GSPMD for the training and serving steps on a
device mesh.

The reference trains on a mesh by jitting its single-device step under
``param_specs`` and ``batch_specs``, and serves by jitting ``prefill``
and ``decode_step`` under ``param_specs`` with the batch rows of every
input and output split over ``decode_axes``' batch axes: GSPMD inserts
the gathers and reductions, and the numbers stay those of the
single-device step.  The port runs one process per mesh member, each
holding its blocks of the parameters (``sharding.shard_params``) and its
rows of each microbatch or serving batch, and :class:`Layout` puts in
what GSPMD would:

* **FSDP over the data dims.**  A block (prefix layer, body layer, the
  loss's table) gathers the leaves the rules split over ``data`` just in
  time (``collectives.gather``: ``all_gather_into_tensor``) and drops them
  after it; under remat the recompute gathers again.  The gather's
  backward is the gradient's reduce-to-shard: a ``reduce_scatter_tensor``
  over the data dims.  A leaf the rules replicate over the data dims has
  its gradient summed over them after the backward
  (:meth:`Layout.reduce_replicated`, one ``all_reduce`` of them all).
* **Tensor parallel over ``model``.**  Attention (the decoder's, the
  whisper encoder's and the cross attention) splits its query heads over
  ``model`` whatever their count: the rank computes the contiguous heads
  ``[i·Hc, min((i+1)·Hc, H))``, ``Hc = ⌈H/|model|⌉`` (:func:`block`, as
  ``param_specs`` blocks split an uneven dim: the last blocks short, some
  empty), and the KV heads they read.  Each other mixer whose heads or
  channels split evenly over ``model`` (:meth:`Layout.mixer_tp`: MLA by
  query heads, RWKV-6 by its 64-wide heads, Mamba by ``d_inner``) and the
  dense FFN keep the rank's column and row blocks (Megatron,
  :data:`TP_MIX`, :data:`TP_FFN`; column blocks are head-major) and
  compute only the rank's heads or channels: a column-parallel product's
  input passes "copy to model" (``TensorParallel.copy_in``: identity
  forward, SUM backward), the row-parallel output "reduce from model".
  A leaf the rank uses only in part but gets whole (a replicated leaf
  such as a bias or RWKV-6's ``u``, or a ``model``-split leaf gathered
  whole: attention's ``wq`` and ``wo`` where the query heads do not split
  evenly, so the stored block is not the rank's heads, ``wk`` and ``wv``
  where ``KV`` does not split, Mamba's ``in_proj``, whose ``[x | z]``
  columns are not the rank's block) passes ``copy_in`` before the mixer
  cuts it (:meth:`TensorParallel.cut`), so its gradient comes back
  summed over ``model``, whole on every rank, and ``reduce_to_shard``
  keeps the rank's block of it.  The mixers' own code
  (``models/attention.py``, ``rwkv6.py``, ``mla.py``, ``mamba.py``) says
  where each ``copy_in`` sits.  An MLA, RWKV-6 or Mamba mixer whose heads
  or channels do not split evenly runs whole on every rank (its leaves
  gathered whole).  The vocabulary stays split: the lookup and the loss
  are vocab-parallel (``collectives.vocab_parallel_embed``,
  ``vocab_parallel_nll``).
* **Expert parallel over ``model``.**  An MoE layer keeps the rank's
  ``E/|model|`` experts of ``w_gate``, ``w_up`` and ``w_down`` and its
  column and row blocks of the shared experts (``sharding.EXPERT_DIMS``),
  gathered over the data dims only, and computes only those
  (``models/moe.py``: every rank routes the whole group, the partial
  outputs are summed over ``model``); the router is gathered whole.
  Where ``E`` or the shared width does not split over ``model``
  (``sharding.expert_parallel``) the experts are gathered whole and run
  whole on every rank.  The frontends are gathered whole just in time
  and run whole on every rank; whisper's encoder layers are gathered
  layer by layer like the decoder's (:meth:`Layout.encoder_layer`).
* **Data parallel.**  The rank runs its rows; the loss is normalised by
  the label count of the *global* microbatch, and MoE layers route the
  reference's groups of the global token stream (``models/moe.py``), so
  the SUM over the data ranks of their losses and gradients is the
  reference's.  Across ``model`` the ranks hold the same activations
  between the blocks and the same gradients of every leaf they share
  (``copy_in`` summed the partial ones): after the backward nothing is
  summed over ``model``.

**Serving** (``transformer.prefill`` and ``decode_step`` with a
``layout``) reuses :meth:`Layout.top` and :meth:`Layout.layer` under
``torch.no_grad()``: the same FSDP gathers a layer, the same
tensor-parallel mixers and dense FFN, the same expert-parallel MoE
layers, no gradient.  What serving adds: the logits are the rank's
vocabulary columns of the (tied) table gathered over ``model``
(:meth:`Layout.logits`); the paged cache stores every KV head (the
pools split the sequence over ``model``), so attention's K and V are
computed whole where ``wk`` and ``wv`` come whole and gathered over
``model`` where they split, and the SP decode takes every query head
(``TensorParallel.gather``); whisper's cross K/V state holds every KV
head too, computed whole in prefill; and a Mamba layer's decode keeps
``in_proj``'s stored ``model`` block and exchanges its outputs
(:meth:`Layout.in_proj_exchange`).  Each data rank serves its batch
rows, and MoE layers route the reference's groups of the global token
stream as in training.

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
from repro_torch.models.layers import unembed
from repro_torch.models.rwkv6 import HEAD_SIZE

#: per mixer, the leaves a tensor-parallel rank keeps as its stored
#: ``model`` block (its heads' or channels' columns, then the output
#: projection's rows); the mixer cuts its other leaves itself.  Attention
#: keeps those whose block is the rank's heads (:meth:`Layout.attn_keep`).
TP_MIX = {"rwkv6": ("wr", "wk", "wv", "wg", "wo"),
          "mla": ("wq_b", "wkv_b", "wo"),
          "mamba": ("dt_proj", "out_proj")}
#: dense-FFN leaves kept tensor-parallel
TP_FFN = ("w_gate", "w_up", "w_down")
#: MoE leaves kept expert-parallel (the rank's experts, the shared
#: experts' columns and rows)
EP_FFN = tuple(EXPERT_DIMS)


def block(n: int, size: int, index: int) -> tuple[int, int]:
    """Member ``index`` of ``size``'s units ``[start, stop)`` of ``n``:
    ``⌈n/size⌉`` a member in member order, the last blocks short and some
    empty where ``size`` does not divide ``n`` (as ``param_specs`` blocks
    and ``vocab_shard`` split an uneven dim).  Fixed by the mesh, never by
    the data."""
    c = -(-n // size)
    return min(index * c, n), min((index + 1) * c, n)


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

    def reduce_product(self, a, w):
        """``a @ w`` summed over ``model``: a row-parallel product whose
        members each hold part of the inner dim.  f32 operands form and
        sum their partial products in f64 and round once, so the result
        is the exact sum rounded, not the members' rounded partials added
        in another order than the single-device product's (the f32 runs
        are held to the single-device step at 1e-5); narrower operands
        sum in their own dtype, as Megatron's bf16 all-reduce does."""
        if a.dtype != torch.float32:
            return self.reduce_out(a @ w)
        return self.reduce_out(a.double() @ w.double()).float()

    def block(self, n: int) -> tuple[int, int]:
        """This rank's units ``[start, stop)`` of ``n`` (:func:`block`)."""
        return block(n, self.size, self.index)

    def cut(self, x, dim: int, unit: int = 1):
        """This rank's block of ``x`` along ``dim`` after :meth:`copy_in`:
        the dim's ``x.shape[dim] / unit`` units (heads of ``unit``
        columns) split as :func:`block` splits them, so a rank may get a
        short block or none.  For a leaf or tensor the rank has whole and
        uses in part, whose gradient then comes back whole on every
        rank."""
        start, stop = self.block(x.shape[dim] // unit)
        return self.copy_in(x).narrow(dim, start * unit,
                                      (stop - start) * unit)

    def gather(self, x, dim: int, size: int | None = None):
        """Every member's block of ``x`` along ``dim``, in member order:
        one ``all_gather_into_tensor`` over ``model`` (serving only: no
        gradient flows back).  The blocks are of one size, or, with
        ``size``, the whole's ``size`` split as :func:`block` splits it
        (short or empty last blocks)."""
        dim %= x.dim()
        shape = list(x.shape)
        shape[dim] = size if size is not None else x.shape[dim] * self.size
        spec = P(*(self.axis if d == dim else None for d in range(x.dim())))
        return coll.gather_shards(x, spec, tuple(shape), self.mesh,
                                  (self.axis,))


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
    def mixer_tp(self, mix: str) -> bool:
        """Whether mixers of family ``mix`` run tensor-parallel: attention
        always on a ``model`` dim of more than one member (a rank computes
        its block of query heads, :func:`block`, and the KV heads they
        read: ``models/attention.py``); MLA, RWKV-6 and Mamba where the
        heads or channels they split by (MLA's query heads, RWKV-6's
        heads, Mamba's ``d_inner``) split evenly over ``model``."""
        if self.tp is None:
            return False
        if mix == "attn":
            return True
        c = self.cfg
        width = {"mla": c.n_heads, "rwkv6": c.d_model // HEAD_SIZE,
                 "mamba": c.d_inner}[mix]
        return width % self.tp.size == 0

    def attn_keep(self) -> tuple:
        """The attention leaves a tensor-parallel rank keeps as its stored
        ``model`` block: ``wq`` and ``wo`` where the query heads split
        evenly over ``model`` (the block is then the rank's heads), and
        ``wk`` and ``wv`` too where ``KV`` does; elsewhere the leaves come
        whole and the mixer cuts the rank's heads from them."""
        c, n = self.cfg, self.tp.size
        if c.n_heads % n:
            return ()
        return ("wq", "wo") + (("wk", "wv") if c.n_kv_heads % n == 0
                               else ())

    def in_proj_exchange(self, mix: str, step: str) -> bool:
        """Whether a layer of family ``mix`` keeps Mamba's ``in_proj`` as
        its stored ``model`` block (a contiguous share of the ``[x | z]``
        columns) and exchanges the product's outputs over ``model``
        instead of gathering the leaf whole: in ``step == "decode"``
        only, where a step's B tokens are far fewer than ``in_proj``'s
        D rows (``models/mamba.py``).  Training and prefill gather it
        whole.  Decided by the entry point, never by the data, so every
        shape stays independent of it."""
        return step == "decode" and mix == "mamba" and self.mixer_tp(mix)

    def layer(self, lp: dict, where: tuple, i: int, step: str = "train"):
        """Layer ``i``'s compute params from its local blocks ``lp`` (at
        ``where`` in the params tree) → (params, tp of the mixer, tp of
        the FFN), a tp None where that part runs whole; an MoE layer's
        FFN tp is its expert-parallel map (``moe_mix``'s ``ep``), and an
        encoder-decoder layer's cross attention runs under the mixer's
        tp.  Under a tp the leaves of :data:`TP_MIX` (attention's of
        :meth:`attn_keep`, the cross attention's ``wq`` and ``wo`` among
        them) or the FFN's are the rank's ``model`` blocks gathered over
        the data dims, every other leaf comes whole; ``step``
        (``"train"``, ``"prefill"`` or ``"decode"``) adds ``in_proj`` to
        them where :meth:`in_proj_exchange` says so."""
        mix, ffn = self.cfg.layer_sig(i)
        return self._block(lp, where, mix, ffn, step)

    def encoder_layer(self, lp: dict, j: int):
        """Whisper encoder layer ``j``'s compute params from its local
        blocks ``lp`` → (params, tp of its attention, tp of its dense
        FFN), as :meth:`layer` gathers a decoder layer's."""
        return self._block(lp, ("encoder", j), "attn", "dense", "train")

    def _block(self, lp: dict, where: tuple, mix: str, ffn: str, step: str):
        tp_mix = self.tp if self.mixer_tp(mix) else None
        tp_ffn = self.tp if (ffn == "dense" or (
            self.tp is not None and expert_parallel(self.cfg, self.tp.size))
        ) else None
        keeps = {"mix": TP_MIX.get(mix, ()),
                 "ffn": TP_FFN if ffn == "dense" else EP_FFN}
        if tp_mix is not None and mix == "attn":
            keeps["mix"] = self.attn_keep()
            # cross wk, wv make every KV head's cross K/V: whole
            keeps["cross"] = tuple(k for k in keeps["mix"]
                                   if k in ("wq", "wo"))
        if self.in_proj_exchange(mix, step):
            keeps["mix"] = keeps["mix"] + ("in_proj",)
        out = {}
        for part, sub in lp.items():
            tp = {"mix": tp_mix, "ffn": tp_ffn, "cross": tp_mix}.get(part)
            keep = keeps.get(part, ())
            out[part] = {}
            for name, t in sub.items():
                at = where + (part, name)
                if tp is not None and name in keep:
                    out[part][name] = self.data_whole(t, at)
                else:
                    out[part][name] = self.whole(t, at)
        return out, tp_mix, tp_ffn

    def top(self, params: dict) -> dict:
        """The params outside the layer stacks for compute: ``embed`` /
        ``unembed`` as this rank's vocabulary rows gathered over the data
        dims, every other leaf whole; ``prefix``, ``body`` and
        ``encoder`` stay local (:meth:`layer` and :meth:`encoder_layer`
        gather them layer by layer)."""
        out = {}
        for k, v in params.items():
            if k in ("prefix", "body", "encoder"):
                out[k] = v
            elif k in ("embed", "unembed"):
                out[k] = self.data_whole(v, (k,))
            else:
                out[k] = self.whole_tree(v, (k,))
        return out

    def logits(self, h, table):
        """Serving's logits: ``h`` (B, D) normed hidden against ``table``,
        this rank's vocabulary rows (:meth:`top`'s ``embed`` or
        ``unembed``) → the rank's (B, V/|model|) f32 columns, gathered
        over ``model`` to (B, V) on every rank."""
        out = unembed(h[:, None], table)[:, 0]
        return out if self.tp is None else self.tp.gather(out, 1,
                                                          self.vocab)

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
