"""Bridge between the reference's arrays and the port's tensors.

The port has no PRNG parity with ``jax.random``, so every parity check
makes its parameters on the reference side and brings them over here as
NumPy arrays (``jax.tree.map(np.asarray, params)``): this module never
imports JAX.  Layouts are unchanged; only the reference's scan stacking
of ``params["body"][j]`` (axis 0 over blocks) is unstacked into a
per-block list, the port's layout.

The way back (:func:`params_to_jax`) and the walk over a port tree by
the reference's leaves (:func:`map_leaves`) serve the training stack:
the reference's optimizer decays a leaf by its *stacked* ndim, its
gradient compression takes one scale per stacked leaf, and its
checkpoints store body leaves stacked, so each needs to know which of
the port's tensors form one reference leaf.  In any port tree a list of
lists is a body: ``body[j][b]`` is block ``b`` of the stack the
reference keeps as the leaves ``body/j/...``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = from_numpy(a, device)
    return t.to(dtype=dtype if t.is_floating_point() else None)


#: leaves the reference makes f32 whatever the model dtype: the MoE
#: router, Mamba's A_log and D, RWKV-6's u and ln_x
F32_LEAVES = ("router", "A_log", "D", "u", "ln_x")


def _tree(x, device, dtype):
    if isinstance(x, dict):
        return {k: _tree(v, device, None if k in F32_LEAVES else dtype)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device, dtype) for v in x]
    return _tensor(x, device, dtype)


def _unstack(tree, b: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, b) for k, v in tree.items()}
    return tree[b]


def _leading(tree) -> int:
    if isinstance(tree, dict):
        return _leading(next(iter(tree.values())))
    return np.shape(tree)[0]


def params_from_jax(tree: dict, *, device="cuda", dtype=None) -> dict:
    """A ``repro.models.transformer.init_params`` tree of NumPy arrays →
    the port's params dict (same keys; ``body[j]`` a list over blocks).
    ``dtype`` casts floating leaves (default: keep), except
    :data:`F32_LEAVES`, which stay f32."""
    out = {k: _tree(v, device, dtype) for k, v in tree.items()
           if k not in ("prefix", "body")}
    out["prefix"] = [_tree(lp, device, dtype) for lp in tree["prefix"]]
    out["body"] = []
    for stacked in tree["body"]:
        n = _leading(stacked)
        out["body"].append([_tree(_unstack(stacked, b), device, dtype)
                            for b in range(n)])
    return out


def state_from_jax(state: dict, *, device="cuda") -> dict:
    """Decode state (``kv``, ``tables``, ``lengths`` as NumPy arrays) →
    tensors with the same layouts and dtypes."""
    return {k: _tensor(v, device) for k, v in state.items()}


# ------------------------------------------------- the way back, and walks
def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists and
    tuples; anything else is a leaf), in the order of :func:`leaves`."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _is_body(x) -> bool:
    return isinstance(x, list) and bool(x) and all(
        isinstance(s, list) for s in x)


def map_leaves(fn, *trees, _key: str = "", _block: int | None = None):
    """``fn(key, block, *leaves)`` over trees of one structure, where
    ``key`` names the reference leaf the way its checkpoints do
    (``"body/0/mix/wq"``, ``"prefix/1/ffn/norm"``, ``"opt/step"``) and
    ``block`` is the tensor's block in a body stack (None outside one)."""
    t = trees[0]
    sub = (lambda k: f"{_key}/{k}") if _key else str
    if isinstance(t, dict):
        return {k: map_leaves(fn, *(x[k] for x in trees), _key=sub(k),
                              _block=_block) for k in t}
    if _is_body(t):
        return [[map_leaves(fn, *blk, _key=sub(j), _block=b)
                 for b, blk in enumerate(zip(*stacks))]
                for j, stacks in enumerate(zip(*trees))]
    if isinstance(t, (list, tuple)):
        return type(t)(map_leaves(fn, *xs, _key=sub(i), _block=_block)
                       for i, xs in enumerate(zip(*trees)))
    return fn(_key, _block, *trees)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view: the caller may go on updating ``t`` in
    place); bfloat16 through ``ml_dtypes``, NumPy's bfloat16."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy(a, device) -> torch.Tensor:
    """A copy of ``a`` on ``device``; bfloat16 from ``ml_dtypes``."""
    a = np.array(a, order="C")              # a copy; a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_to_jax(tree):
    """The inverse of :func:`params_from_jax`, for any port tree (params,
    optimizer state, both in one dict): NumPy arrays in the reference's
    layout, each body's blocks stacked along axis 0 and every sequence a
    tuple."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if _is_body(tree):
        return tuple(tree_map(lambda *xs: np.stack(xs),
                              *[params_to_jax(blk) for blk in stack])
                     for stack in tree)
    if isinstance(tree, (list, tuple)):
        return tuple(params_to_jax(v) for v in tree)
    return to_numpy(tree)
