"""AdamW with decoupled weight decay + global-norm clipping.

PyTorch counterpart of ``repro.training.optimizer``.  Moments are f32
regardless of param dtype unless ``moments_dtype`` narrows their storage;
the update is computed in f32 and cast back.

The reference skips weight decay on leaves of ndim < 2 (norms, biases),
and it tests the ndim of its *stacked* leaf: a body leaf carries a
leading block axis, so body norms and biases are decayed while prefix,
encoder and ``final_norm`` ones are not.  The port keeps body blocks as
per-block lists, so the rule here adds that axis back
(:func:`repro_torch.bridge.map_leaves` says which tensors are blocks).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.bridge import leaves, map_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    #: moment dtype: f32 default; bf16 halves optimizer memory for ≥100B
    #: models (update math stays f32 — only storage narrows)
    moments_dtype: str = "float32"


def init_opt_state(params, moments_dtype: str = "float32") -> dict:
    dt = getattr(torch, moments_dtype)
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = leaves(params)[0].device
    return {"mu": tree_map(z, params),
            "nu": tree_map(z, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, *, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element.  On a ``mesh`` the
    tree holds this rank's blocks under ``specs``: each logical element
    counts once, as one SUM over the mesh of each block's sum of squares
    divided by the number of ranks holding that block."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves(tree)))
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    world = coll.axis_size(mesh, tuple(sizes))
    local = map_leaves(
        lambda key, block, x, spec: torch.sum(torch.square(x.float())) * (
            coll.axis_size(mesh, coll.split_axes(spec)) / world),
        tree, specs)
    return torch.sqrt(coll.all_reduce(sum(leaves(local)).reshape(1), mesh,
                                      tuple(sizes))[0])


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then constant."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *,
                 donate: bool = False, mesh=None, specs=None):
    """Returns (new_params, new_state, metrics).  With ``donate`` the new
    values are written into ``params`` and the moments (the reference
    donates their buffers to its jitted step), so an update holds a few
    of one leaf's temporaries at a time, not a second copy of the tree.
    In-place or not, each value is rounded as in the reference's
    expressions.  On a ``mesh`` every tree holds this rank's blocks
    under ``specs``: only the norm is global (:func:`global_norm`), the
    update is elementwise."""
    step = state["step"] + 1
    gnorm = global_norm(grads, mesh=mesh, specs=specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(cfg, state["step"])
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    mdt = getattr(torch, cfg.moments_dtype)

    def times(t, c):
        """t·c in f32, written into t when the update owns it."""
        if donate and t.dtype == torch.float32:
            return t.mul_(c)
        return t.float() * c

    def upd(key, block, p, g, m, v):
        g = g.float() * scale
        m_new = times(m, cfg.b1)
        m_new += (1 - cfg.b1) * g
        v_new = times(v, cfg.b2)
        v_new += torch.square(g).mul_(1 - cfg.b2)
        del g
        step_ = m_new / b1c                               # mhat
        step_ /= torch.sqrt(v_new / b2c).add_(cfg.eps)    # sqrt(vhat) + eps
        if p.dim() + (block is not None) >= 2:     # no decay on norms/biases
            step_ += cfg.weight_decay * p.float()
        step_ *= lr
        if donate and p.dtype == torch.float32:
            p_new = p.sub_(step_)
        else:
            p_new = (p.float() - step_).to(p.dtype)
        out = (p_new, m_new.to(mdt), v_new.to(mdt))
        if donate:
            for dst, src in zip((p, m, v), out):
                if src is not dst:
                    dst.copy_(src)
            return p, m, v
        return out

    out = map_leaves(upd, params, grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)
    return (pick(0), {"mu": pick(1), "nu": pick(2), "step": step},
            {"grad_norm": gnorm, "lr": lr})
