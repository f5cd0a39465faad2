"""Int8 error-feedback gradient compression.

PyTorch counterpart of ``repro.training.grad_compression``: each leaf is
quantised to int8 with one absmax scale, and the quantisation error is
carried into the next step (error feedback keeps the long-run average
unbiased).

The reference takes one scale per *reference* leaf, and a body leaf is a
stack over blocks, so here one scale covers all the blocks of a body
leaf (:func:`repro_torch.bridge.map_leaves` names it), not one per
block.
``compressed_psum``, the explicit reduction of the int8 payload across
ranks, needs the port's distributed slice and is not here.
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
def compress_tree(grads, err_state):
    """Returns ((quantised tree, scale tree), new_err_state); every block
    of a body leaf carries that leaf's one scale."""
    gf = tree_map(lambda g, e: g.float() + e, grads, err_state)
    absmax = {}
    map_leaves(lambda key, _, x: absmax.setdefault(key, []).append(
        x.abs().max()), gf)
    scales = {k: _scale(torch.stack(v).max()) for k, v in absmax.items()}
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
