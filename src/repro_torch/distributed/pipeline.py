"""GPipe-style pipeline parallelism over a "pipe" mesh dim.

Counterpart of ``repro.distributed.pipeline``, one process a stage
(SPMD, as ``collectives.py``): microbatches fill the pipeline in the
reference's (S + n_micro − 1)-tick schedule, every stage applying
``stage_fn`` at every tick, bubbles included, and handing its output to
the next stage around a ring.  The reference's handoff is a
``ppermute``; here it is one ``broadcast`` per stage per tick, each
rank keeping its predecessor's: gloo refuses ``send``/``recv`` on CUDA
tensors (``distributed/probe.py``), and the ranks of one card can meet
only over gloo.  Forward only, as the reference's check uses it.
"""

from __future__ import annotations

import torch

from repro_torch.bridge import tree_map
from repro_torch.distributed import collectives as coll


def pipeline_apply(stage_fn, stage_params, x, *, mesh, axis: str = "pipe",
                   n_microbatches: int | None = None):
    """stage_params: this rank's block of the stacked stage params
    (leaves (1, ...), the reference's ``P(axis)`` shard); x: the whole
    (n_micro, mb, ...) on every rank.

    Returns (n_micro, mb, ...) = stage_{S-1}(…stage_0(x)…) per
    microbatch on every rank: the last stage's outputs (the reference
    returns ``outs[-1]``, the last stage's view)."""
    axes = (axis,)
    n_stages = coll.axis_size(mesh, axes)
    n_micro = x.shape[0] if n_microbatches is None else n_microbatches
    if x.shape[0] != n_micro:
        raise ValueError(f"x has {x.shape[0]} microbatches, expected "
                         f"{n_micro}")
    s = coll.axis_index(mesh, axes)
    p = tree_map(lambda t: t[0], stage_params)
    act = torch.zeros_like(x[0])
    outs = []
    with torch.no_grad():
        for t in range(n_micro + n_stages - 1):
            act_in = x[min(t, n_micro - 1)] if s == 0 else act
            out = stage_fn(p, act_in)
            outs.append(out)
            # the ring: stage i's output goes to stage (i + 1) % S
            for src in range(n_stages):
                buf = (out.clone(memory_format=torch.contiguous_format)
                       if src == s else torch.empty(
                           out.shape, dtype=out.dtype, device=out.device))
                coll.broadcast(buf, mesh, axes, src)
                if src == (s - 1) % n_stages:
                    act = buf
        # stage S−1 emits microbatch t−(S−1) at tick t
        last = (torch.stack(outs[n_stages - 1:]) if s == n_stages - 1
                else torch.empty((n_micro,) + tuple(out.shape),
                                 dtype=out.dtype, device=out.device))
        return coll.broadcast(last, mesh, axes, n_stages - 1)
