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
Sharding over a mesh needs the port's distributed slice.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch

from repro_torch.bridge import leaves, tree_map
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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "training over a mesh needs the port's distributed/ slice "
            "(ROADMAP Queue 1 item 4)")


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None,
                    donate: bool = True):
    """Returns ``step``.  With ``donate`` (the reference donates its
    params, optimizer and error state to the jitted step) the step updates
    ``params`` and the moments in place and returns them; the params that
    come out never require grad."""
    _no_mesh(mesh)
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


def train(cfg: ModelConfig, tc: TrainConfig, data_iter, *, steps: int,
          ckpt_mgr=None, ckpt_every: int = 100, mesh=None,
          seed: int = 0, log_every: int = 10, dtype=torch.bfloat16,
          params=None, opt_state=None, device="cuda") -> dict:
    """Driver with checkpoint/restart.  Returns the metrics history
    ``{"loss": [...], "step_time": [...]}``.  Given ``params`` (and
    ``opt_state``), trains them in place on their device; otherwise
    initialises from ``seed`` on ``device``."""
    _no_mesh(mesh)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params, opt_state, err_state = init_all(gen, cfg, tc, dtype)
    else:
        err_state = (init_error_state(params) if tc.compress_grads
                     else torch.zeros((), dtype=torch.float32))
    dev = leaves(params)[0].device
    err_state = tree_map(lambda e: e.to(dev), err_state)

    start = 0
    if ckpt_mgr is not None and ckpt_mgr.latest_step() is not None:
        start = ckpt_mgr.latest_step()
        state = ckpt_mgr.restore(start, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]

    step_fn = make_train_step(cfg, tc)
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
