"""Train step factory + fault-tolerant training driver.

PyTorch counterpart of ``repro.training.train_loop``.  ``make_train_step``
builds the step

    (params, opt_state, err_state, batch) → (params, opt_state, err_state,
                                             metrics)

with microbatched gradient accumulation (activation memory bounded by a
microbatch, not the global batch), optional int8 error-feedback gradient
compression, remat of the model's body blocks and the flash-style
backward of ``chunked_attention``.  Gradients come from autograd through
``repro_torch.models.transformer.loss_fn``; the CUDA kernels are forward
only, so ``attn_impl`` is ``"chunked"`` (or ``"direct"``, the O(S²)
oracle), as the reference trains through ``"chunked"``.

``train`` is the driver: checkpoint/restart, data that is a pure function
of the step, step timing, NaN guard.  Entry points run on the card
unless the caller passes ``device="cpu"`` (or params that live there).
On a mesh (``mesh``: a ``torch.distributed`` DeviceMesh, one process a
member) both give the reference's sharded step: the same numbers as its
single-device step, with parameters, moments and error state held as
shards (``distributed/parallel.py``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.bridge import leaves, tree_map
from repro_torch.distributed import sharding as shard_rules
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.grad_compression import (compress_tree,
                                                   decompress_tree,
                                                   init_error_state)


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    adamw: opt_mod.AdamWConfig = field(default_factory=opt_mod.AdamWConfig)
    compress_grads: bool = False
    attn_impl: str = "chunked"           # 'chunked' | 'direct' (the oracle)
    moe_groups: int = 1
    remat: bool = True
    #: microbatch gradient-accumulation dtype (bf16 halves the accumulator
    #: tree for ≥100B models; f32 default)
    accum_dtype: str = "float32"


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None,
                    donate: bool = True):
    """Returns ``step``.  With ``donate`` (the reference donates its
    params, optimizer and error state to the jitted step) the step updates
    ``params`` and the moments in place and returns them; the params that
    come out never require grad.  On a ``mesh`` the step is
    :func:`_mesh_step`'s."""
    if mesh is not None:
        _check_mesh(mesh)
        return _mesh_step(cfg, tc, mesh, donate)
    adt = getattr(torch, tc.accum_dtype)

    def value_and_grad(params, batch):
        # detached aliases that record autograd: the caller's tensors stay
        # plain, and no weight is copied
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = tfm.loss_fn(live, cfg, batch, impl=tc.attn_impl,
                               remat=tc.remat, moe_groups=tc.moe_groups)
            grads = torch.autograd.grad(loss, leaves(live),
                                        allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def step(params, opt_state, err_state, batch):
        n = tc.microbatches
        if n == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=opt_state["step"].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                   device=p.device), params)
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(params, mb)
                tree_map(lambda a, b: a.add_(b.to(adt)), grads, g)
                loss = loss + l
            inv = 1.0 / n
            loss = loss * inv
            tree_map(lambda g: g.mul_(inv), grads)

        if tc.compress_grads:
            qtree, err_state = compress_tree(grads, err_state)
            grads = decompress_tree(qtree, like=grads)

        params, opt_state, metrics = opt_mod.adamw_update(
            params, grads, opt_state, tc.adamw, donate=donate)
        metrics["loss"] = loss
        return params, opt_state, err_state, metrics

    return step


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")


def _microbatches(batch: dict, n: int):
    """Microbatch i: rows [i·B/n, (i+1)·B/n) of the batch."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


def _mesh_step(cfg: ModelConfig, tc: TrainConfig, mesh, donate: bool):
    """The reference's step jitted under ``param_specs`` and
    ``batch_specs``, one process a mesh member.

    ``params``, the moments and the error state are DTensors of this
    rank's blocks under ``param_specs`` (``sharding.shard_params``; the
    error state a zero 0-d tensor without ``compress_grads``, the
    optimizer's ``step`` a plain scalar); ``batch`` is the whole global
    batch on every rank.  Microbatch i is rows [i·B/n, (i+1)·B/n) of
    the global batch, and the rank computes on its rows of it (its block
    under ``batch_specs``).  Gradients come back summed over the data
    ranks and cut to the rank's blocks (``distributed/parallel.py``),
    are compressed if asked (one scale per whole leaf), and AdamW
    updates the blocks with the global norm.  The metrics are those of
    the whole batch on every rank."""
    from repro_torch.distributed import parallel
    from repro_torch.distributed.collectives import local_shard
    adt = getattr(torch, tc.accum_dtype)
    bspecs = shard_rules.batch_specs(mesh, has_patches=True, has_frames=True)
    held = {}

    def layout(params):
        if "layout" not in held:
            specs = shard_rules.param_specs(params, mesh)
            held["layout"] = parallel.Layout(cfg, mesh, specs,
                                             parallel.shapes_of(params))
        return held["layout"]

    def value_and_grad(local, lay, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(), local)
        with torch.enable_grad():
            loss = tfm.loss_fn(live, cfg, mb, impl=tc.attn_impl,
                               remat=tc.remat, moe_groups=tc.moe_groups,
                               layout=lay)
            grads = torch.autograd.grad(loss, leaves(live),
                                        allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), local)
        return loss.detach(), lay.reduce_replicated(grads)

    def step(params, opt_state, err_state, batch):
        lay = layout(params)
        local = shard_rules.local_blocks(params)
        mu, nu = (shard_rules.local_blocks(opt_state[k]) for k in ("mu",
                                                                   "nu"))
        n = tc.microbatches
        loss = torch.zeros((), dtype=torch.float32,
                           device=opt_state["step"].device)
        grads = None
        for mb in _microbatches(batch, n):
            mine = {k: local_shard(v, bspecs[k], mesh) for k, v in mb.items()}
            l, g = value_and_grad(local, lay, mine)
            loss = loss + l
            if n == 1:
                grads = g
            elif grads is None:
                grads = tree_map(lambda x: x.to(adt), g)
            else:
                tree_map(lambda a, b: a.add_(b.to(adt)), grads, g)
        if n > 1:
            loss = loss * (1.0 / n)
            tree_map(lambda g: g.mul_(1.0 / n), grads)
        loss = lay.dp.sum(loss)

        def wrap(tree, like):          # new blocks as DTensors like ``like``
            return tree_map(lambda t, d: shard_rules.map_shards(
                lambda _: t, d), tree, like)

        if tc.compress_grads:
            err = shard_rules.local_blocks(err_state)
            qtree, new_err = compress_tree(grads, err, mesh=mesh)
            grads = decompress_tree(qtree, like=grads)
            if donate:
                tree_map(lambda dst, src: dst.copy_(src), err, new_err)
            else:
                err_state = wrap(new_err, err_state)

        new, opt_local, metrics = opt_mod.adamw_update(
            local, grads, {"mu": mu, "nu": nu, "step": opt_state["step"]},
            tc.adamw, donate=donate, mesh=mesh, specs=lay.specs)
        metrics["loss"] = loss
        if donate:
            opt_state = dict(opt_state, step=opt_local["step"])
            return params, opt_state, err_state, metrics
        return (wrap(new, params),
                {"mu": wrap(opt_local["mu"], opt_state["mu"]),
                 "nu": wrap(opt_local["nu"], opt_state["nu"]),
                 "step": opt_local["step"]}, err_state, metrics)

    return step


def init_all(generator: torch.Generator, cfg: ModelConfig, tc: TrainConfig,
             dtype=torch.bfloat16):
    """Params, optimizer state and error state on ``generator``'s device."""
    params = tfm.init_params(cfg, generator=generator,
                             device=generator.device, dtype=dtype)
    opt_state = opt_mod.init_opt_state(params)
    err_state = (init_error_state(params) if tc.compress_grads
                 else torch.zeros((), dtype=torch.float32,
                                  device=generator.device))
    return params, opt_state, err_state


def shard_state(params, opt_state, tc: TrainConfig, mesh):
    """Params and moments as DTensors of this rank's blocks (whole ones
    are sharded; fresh moments are made on the blocks), and the error
    state: zeros like the params' blocks with ``compress_grads``."""
    def sharded(tree):
        return (tree if isinstance(leaves(tree)[0], DTensor)
                else shard_rules.shard_params(tree, mesh))
    params = sharded(params)
    dev = shard_rules.local_blocks(leaves(params)[0]).device
    zeros = lambda dt: shard_rules.map_shards(
        lambda t: torch.zeros(t.shape, dtype=dt, device=t.device), params)
    if opt_state is None:
        mdt = getattr(torch, tc.adamw.moments_dtype)
        opt_state = {"mu": zeros(mdt), "nu": zeros(mdt),
                     "step": torch.zeros((), dtype=torch.int32, device=dev)}
    else:
        opt_state = dict(opt_state, mu=sharded(opt_state["mu"]),
                         nu=sharded(opt_state["nu"]))
    err_state = (zeros(torch.float32) if tc.compress_grads
                 else torch.zeros((), dtype=torch.float32, device=dev))
    return params, opt_state, err_state


def train(cfg: ModelConfig, tc: TrainConfig, data_iter, *, steps: int,
          ckpt_mgr=None, ckpt_every: int = 100, mesh=None,
          seed: int = 0, log_every: int = 10, dtype=torch.bfloat16,
          params=None, opt_state=None, device="cuda") -> dict:
    """Driver with checkpoint/restart.  Returns the metrics history
    ``{"loss": [...], "step_time": [...]}``.  Given ``params`` (and
    ``opt_state``), trains them in place on their device; otherwise
    initialises from ``seed`` on ``device``.

    On a ``mesh`` (one process a member) params, moments and error
    state are held as this rank's blocks under ``param_specs``
    (``sharding.shard_params``; given whole params or moments are sharded
    first), a checkpoint is restored onto the mesh and saved per shard,
    and every rank reads the whole batch of each step."""
    if mesh is not None:
        _check_mesh(mesh)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        if mesh is None:
            params, opt_state, err_state = init_all(gen, cfg, tc, dtype)
        else:           # the moments and error state are made on the blocks
            params = tfm.init_params(cfg, generator=gen, device=gen.device,
                                     dtype=dtype)
    elif mesh is None:
        err_state = (init_error_state(params) if tc.compress_grads
                     else torch.zeros((), dtype=torch.float32))
    if mesh is not None:
        params, opt_state, err_state = shard_state(params, opt_state, tc,
                                                  mesh)
    dev = shard_rules.local_blocks(leaves(params)[0]).device
    err_state = tree_map(lambda e: e.to(dev), err_state)

    start = 0
    if ckpt_mgr is not None and ckpt_mgr.latest_step() is not None:
        start = ckpt_mgr.latest_step()
        like = {"params": params, "opt": opt_state}
        if mesh is None:
            state = ckpt_mgr.restore(start, like)
        else:
            ps = shard_rules.param_specs(params, mesh)
            state = ckpt_mgr.restore(start, like, mesh=mesh, specs={
                "params": ps,
                "opt": {"mu": ps, "nu": ps, "step": shard_rules.P()}})
            state["opt"]["step"] = state["opt"]["step"].to_local()
        params, opt_state = state["params"], state["opt"]

    step_fn = make_train_step(cfg, tc, mesh)
    hist = {"loss": [], "step_time": []}
    for s in range(start, steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data_iter.batch(s).items()}
        t0 = time.perf_counter()
        params, opt_state, err_state, metrics = step_fn(
            params, opt_state, err_state, batch)
        loss = float(metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {s}: {loss}")
        hist["loss"].append(loss)
        hist["step_time"].append(dt)
        if log_every and s % log_every == 0:
            print(f"step {s:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  {dt*1e3:7.1f}ms")
        if ckpt_mgr is not None and (s + 1) % ckpt_every == 0:
            ckpt_mgr.save(s + 1, {"params": params, "opt": opt_state},
                          blocking=False)
    if ckpt_mgr is not None:
        ckpt_mgr.wait()
    return hist
