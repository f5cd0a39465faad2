"""One rank of the port's checks of serving from sharded weights.  No JAX
here.

    python tests/_torch_serve_ranks.py RANK WORLD WORKDIR

One of the four ranks ``tests/test_torch_serve_mesh.py`` starts: the test
pickled the cases (params in the reference's layout, prompts, frames and
patches, configs, meshes) into ``WORKDIR/inputs.pkl`` and computes the
reference's answers while the ranks run.  Every rank joins a gloo process
group through a file under WORKDIR and runs every case:

* ``serve``: the case's params cut to this rank's blocks under
  ``param_specs`` (``sharding.shard_params``, the whole params dropped),
  a ``Layout``, the decode state cut by ``collectives.local_state(
  layout=)``, then ``prefill`` of the rank's batch rows and greedy
  ``decode_step(page_impl=...)`` steps: the whole batch's logits
  (``gather_batch``), what the rank holds and computes with (held blocks
  against ``shard_of`` of the whole params, state shapes, each layer's
  compute shapes in prefill and decode, the mixers' heads and channels,
  the rows of its logits) and the collectives of the first decode step;
* ``restore``: the tiny config trained one step by ``make_train_step``
  on the mesh, saved, restored onto the mesh with
  ``CheckpointManager.restore(mesh=, specs=)`` and served from the
  restored blocks, beside the same checkpoint served whole on one
  process.

Each rank writes ``result_<rank>.pkl``: per case its values or the
traceback.  A case that raises on one rank alone leaves the others in a
collective; the parent's timeout then stops them.
"""

from __future__ import annotations

import pickle
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import map_leaves, params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import parallel, sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention, mla
from repro_torch.models import transformer as tfm
from repro_torch.models.config import AttnConfig, ModelConfig
from repro_torch.models.layers import rms_norm


def config(spec) -> ModelConfig:
    """A dict of ModelConfig fields (``attn`` a dict of AttnConfig's), or
    the name of a smoke config."""
    if isinstance(spec, dict):
        spec = dict(spec)
        if isinstance(spec.get("attn"), dict):
            spec["attn"] = AttnConfig(**spec["attn"])
        return ModelConfig(**spec)
    return get_smoke(spec)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def shapes(tree) -> dict:
    return {p: {k: list(v.shape) for k, v in d.items()}
            for p, d in tree.items()}


def held_blocks(whole, sharded, mesh) -> list:
    """The leaves whose local block differs from ``shard_of`` of the
    whole leaf under ``param_specs``."""
    bad = []
    specs = sharding.param_specs(whole, mesh)

    def check(key, block, w, d, spec):
        spec = spec if block is None else sharding.P(*spec[1:])
        if not torch.equal(d.to_local(), sharding.shard_of(w, spec, mesh)):
            bad.append(key)
    map_leaves(check, whole, sharded, specs)
    return bad


def mixer_widths(cfg, mix, lp, tp) -> dict:
    """What the mixer computes with the layer's compute params on a
    (1, 2, D) input: attention's query and KV heads and the fused K/V it
    writes, MLA's query heads (the recurrent mixers' channels and heads
    show in the state's shapes)."""
    x = torch.randn(1, 2, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    pos = torch.arange(2)[None]
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    if mix == "attn" and tp is not None:
        q, k, _, kv = attention.serving_qkv(lp, h, cfg, pos, tp)
        return {"q": list(q.shape), "k": list(k.shape), "kv": list(kv.shape)}
    if mix == "mla":
        q_nope, _ = mla._project_q(lp, h, cfg, pos, tp)
        return {"q": list(q_nope.shape)}
    return {}


def serve_case(c, mesh, work):
    cfg = config(c["cfg"])
    whole = params_from_jax(c["params"], device="cpu")
    prompt = t(c["prompt"])
    B = prompt.shape[0]
    ba, sa = sharding.decode_axes(mesh, batch=B)
    sharded = sharding.shard_params(whole, mesh)
    held = held_blocks(whole, sharded, mesh)
    del whole
    lay = parallel.Layout(cfg, mesh, sharding.param_specs(sharded, mesh),
                          parallel.shapes_of(sharded))
    local = sharding.local_blocks(sharded)
    st = tfm.init_decode_state(
        cfg, B, c["max_len"], batch_shards=coll.axis_size(mesh, ba),
        seq_shards=coll.axis_size(mesh, sa), device="cpu")
    st = coll.local_state(st, cfg, mesh, batch_axes=ba, seq_axes=sa,
                          layout=lay)
    state_shapes = {k: list(v.shape) for k, v in st.items()}

    def rows(a):
        return coll.local_shard(t(a), (ba,), mesh)
    extras = {k: rows(v) for k, v in c["extras"].items()}
    kw = dict(batch_axes=ba, seq_axes=sa, layout=lay)
    logits, st = tfm.prefill(local, cfg, rows(c["prompt"]), st, **extras,
                             **kw)
    local_rows = list(logits.shape)
    got = [coll.gather_batch(logits, mesh, ba, B)]
    traffic = None
    for step in range(c["new"]):
        tok = logits.argmax(-1).to(torch.int32)
        coll.TRAFFIC.reset()
        logits, st = tfm.decode_step(local, cfg, st, tok,
                                     page_impl=c["impl"], **kw)
        if step == 0:
            traffic = {(k, r): v for (k, r), v in coll.TRAFFIC.groups.items()}
        got.append(coll.gather_batch(logits, mesh, ba, B))
    compute = {}
    for step in ("prefill", "decode"):
        per = compute[step] = []
        for i in range(cfg.n_layers):
            lp, tp_mix, tp_ffn = lay.layer(tfm.layer_params(local, cfg, i),
                                           tfm._layer_where(cfg, i), i, step)
            per.append({"params": shapes(lp),
                        "tp": [tp_mix is not None, tp_ffn is not None],
                        "mixer": mixer_widths(cfg, cfg.mixers[i], lp["mix"],
                                              tp_mix)})
    return {"logits": torch.stack(got).numpy(), "held_differ": held,
            "state": state_shapes, "logits_rows": local_rows,
            "compute": compute, "traffic": traffic,
            "batch_axes": list(ba), "seq_axes": list(sa)}


def restore_case(c, mesh, work):
    """One ``make_train_step`` step of the tiny config on the mesh, its
    params saved and restored onto the mesh, then served from the
    restored blocks and, whole, on this process alone."""
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_loop as ttl
    from repro_torch.training.checkpoint import CheckpointManager
    cfg = config(c["cfg"])
    tc = ttl.TrainConfig(adamw=topt.AdamWConfig(lr=1e-3, warmup_steps=1))
    params, opt, err = ttl.shard_state(
        params_from_jax(c["params"], device="cpu"), None, tc, mesh)
    batch = {k: t(v) for k, v in c["batch"].items()}
    params, *_ = ttl.make_train_step(cfg, tc, mesh)(params, opt, err, batch)
    mgr = CheckpointManager(f"{work}/ckpt")
    mgr.save(1, params)
    like = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    coll.TRAFFIC.reset()
    restored = mgr.restore(1, like, mesh=mesh,
                           specs=sharding.param_specs(like, mesh))
    restore_calls = coll.TRAFFIC.calls
    prompt = t(c["prompt"])
    B = prompt.shape[0]
    ba, sa = sharding.decode_axes(mesh, batch=B)
    lay = parallel.Layout(cfg, mesh, sharding.param_specs(restored, mesh),
                          parallel.shapes_of(restored))
    local = sharding.local_blocks(restored)
    one = mgr.restore(1, like)              # the same params, whole
    held = held_blocks(one, restored, mesh)
    st = tfm.init_decode_state(
        cfg, B, c["max_len"], batch_shards=coll.axis_size(mesh, ba),
        seq_shards=coll.axis_size(mesh, sa), device="cpu")
    st = coll.local_state(st, cfg, mesh, batch_axes=ba, seq_axes=sa,
                          layout=lay)
    kw = dict(batch_axes=ba, seq_axes=sa, layout=lay)
    rows = coll.local_shard(prompt, (ba,), mesh)
    logits, st = tfm.prefill(local, cfg, rows, st, **kw)
    got = [coll.gather_batch(logits, mesh, ba, B)]
    for _ in range(c["new"]):
        logits, st = tfm.decode_step(local, cfg, st, logits.argmax(-1).to(
            torch.int32), page_impl="sp", **kw)
        got.append(coll.gather_batch(logits, mesh, ba, B))
    st1 = tfm.init_decode_state(cfg, B, c["max_len"], device="cpu")
    with torch.no_grad():
        logits, st1 = tfm.prefill(one, cfg, prompt, st1)
        want = [logits]
        for _ in range(c["new"]):
            logits, st1 = tfm.decode_step(one, cfg, st1, logits.argmax(
                -1).to(torch.int32))
            want.append(logits)
    return {"mesh": torch.stack(got).numpy(),
            "whole": torch.stack(want).numpy(),
            "restore_calls": restore_calls, "held_differ": held}


RUNNERS = {"serve": serve_case, "restore": restore_case}


def main() -> None:
    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    with open(f"{work}/inputs.pkl", "rb") as f:
        cases = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    meshes = {}
    results = {}
    for name, c in cases.items():
        shape = tuple(c["mesh"])
        if shape not in meshes:              # every rank builds each once
            meshes[shape] = make_host_mesh(*shape, device_type="cpu")
        try:
            value = RUNNERS[c["kind"]](c, meshes[shape], f"{work}/{name}")
            results[name] = {"ok": True, "value": value}
        except Exception:
            results[name] = {"ok": False, "error": traceback.format_exc()}
    with open(f"{work}/result_{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
