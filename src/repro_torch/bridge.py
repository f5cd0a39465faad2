"""Bridge from the reference's arrays to the port's tensors.

The port has no PRNG parity with ``jax.random``, so every parity check
makes its parameters on the reference side and brings them over here as
NumPy arrays (``jax.tree.map(np.asarray, params)``): this module never
imports JAX.  Layouts are unchanged; only the reference's scan stacking
of ``params["body"][j]`` (axis 0 over blocks) is unstacked into a
per-block list, the port's layout.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype if t.is_floating_point() else None)


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
