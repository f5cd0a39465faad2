"""Int8 error-feedback gradient compression.

PyTorch counterpart of ``repro.training.grad_compression``: each leaf is
quantised to int8 with one absmax scale, and the quantisation error is
carried into the next step (error feedback keeps the long-run average
unbiased).

The reference takes one scale per *reference* leaf, and a body leaf is a
stack over blocks, so here one scale covers all the blocks of a body
leaf (:func:`repro_torch.bridge.map_leaves` names it), not one per
block.
On a mesh :func:`compress_tree` takes each leaf's scale over all of
its blocks (a MAX over the ranks); :func:`compressed_psum` is the
explicit reduction of the int8 payload across ranks.
"""

from __future__ import annotations

import torch

from repro_torch.bridge import map_leaves, tree_map


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantise(gf: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, gf - q.float() * scale


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(absmax, min=1e-12) / 127.0


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """g + err → (q int8, scale f32 scalar, new_err)."""
    gf = g.float() + err
    scale = _scale(gf.abs().max())
    q, new_err = _quantise(gf, scale)
    return q, scale, new_err


@torch.no_grad()
def compress_tree(grads, err_state, *, mesh=None):
    """Returns ((quantised tree, scale tree), new_err_state); every block
    of a body leaf carries that leaf's one scale.  On a ``mesh`` the
    trees hold this rank's blocks (the error state sharded like the
    parameter) and each leaf's absmax is a MAX over the mesh, so the
    scale is the one of the whole leaf."""
    gf = tree_map(lambda g, e: g.float() + e, grads, err_state)
    absmax = {}
    map_leaves(lambda key, _, x: absmax.setdefault(key, []).append(
        x.abs().max() if x.numel() else x.new_zeros(())), gf)
    top = torch.stack([torch.stack(v).max() for v in absmax.values()])
    if mesh is not None:
        from repro_torch.distributed import collectives as coll
        names = tuple(coll.axis_sizes(mesh))
        coll.all_reduce(top, mesh, names, coll.dist.ReduceOp.MAX)
    scales = dict(zip(absmax, _scale(top).unbind()))
    out = map_leaves(lambda key, _, x: (*_quantise(x, scales[key]),
                                        scales[key]), gf)
    pick = lambda i: tree_map(lambda _, o: o[i], grads, out)
    return (pick(0), pick(2)), pick(1)


def decompress_tree(qtree, like=None):
    qs, scales = qtree
    out = tree_map(lambda q, s: q.float() * s, qs, scales)
    if like is not None:
        out = tree_map(lambda o, l: o.to(l.dtype), out, like)
    return out


@torch.no_grad()
def compressed_psum(grads, err_state, axis, *, mesh):
    """The reference's ``shard_map`` body, one process a member: this
    rank's gradients int8-compressed with its own scales (error feedback
    into ``err_state``), the payload summed over the mesh dims ``axis``
    (a name or a tuple) widened to int32 (int8 accumulation overflows),
    and dequantised with the mean of the ranks' scales.  Returns (the
    summed gradients, new_err_state); one int32 and one f32
    ``all_reduce``."""
    from repro_torch.bridge import leaves
    from repro_torch.distributed import collectives as coll
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    (qs, scales), new_err = compress_tree(grads, err_state)
    flat = coll.all_reduce(torch.cat([q.reshape(-1).to(torch.int32)
                                      for q in leaves(qs)]), mesh, axes)
    n = coll.axis_size(mesh, axes)
    mean = coll.all_reduce(torch.stack(leaves(scales)), mesh, axes) / n
    it = iter(range(len(mean)))
    off = [0]

    def out(q):
        i, k = next(it), q.numel()
        s = flat[off[0]:off[0] + k].view(q.shape).float() * mean[i]
        off[0] += k
        return s
    return tree_map(out, qs), new_err
