"""One rank of the port's mesh-training checks.  No JAX here.

    python tests/_torch_train_ranks.py RANK WORLD WORKDIR

One of the four ranks ``tests/test_torch_train_mesh*.py`` start (or of
the two on one GPU that ``tests/test_torch_kernels_cuda.py`` starts: the
inputs then say ``"device": "cuda"``): the test pickled the cases
(params in the reference's layout, batches, configs) into
``WORKDIR/inputs.pkl`` and computes its answers while the ranks run.
Every rank joins a gloo process group through a file under WORKDIR and
runs every case:

* ``step``: ``make_train_step(cfg, tc, mesh)`` on a (data, model) mesh
  for a few steps from the given params; the losses and grad norms of
  every step, and the whole params, first moments (and error state)
  after the first;
* ``train``: ``train(mesh=)`` uninterrupted, and stopped then restarted
  from its sharded checkpoint: the losses of both and the final
  checkpoints' leaves;
* ``psum``: ``compressed_psum`` of this rank's gradients over "data";
* ``pipeline``: ``pipeline_apply`` on a ("pipe",) mesh of the four ranks;
* ``layout``: the shapes a rank holds of one layer (and of an
  encoder-decoder model's first encoder layer) and computes with, and
  the bytes its mixer's and its FFN's gathers move;
* ``serve``: ``tests/_torch_serve_ranks.py``'s case of that name
  (serving from the rank's blocks), for a module that trains and serves
  on one start of the ranks.

Each rank writes ``result_<rank>.pkl``: per case its values (``psum``,
``layout`` and ``serve`` per rank, the rest from rank 0) or the
traceback.  A case that raises on
one rank alone leaves the others in a collective; the parent's timeout
then stops them.
"""

from __future__ import annotations

import pickle
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.bridge import map_leaves, params_from_jax, params_to_jax
from repro_torch.configs import get_smoke
from repro_torch.distributed.elastic import assemble, shard_entries
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import AttnConfig, ModelConfig
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.grad_compression import compressed_psum


def config(spec) -> ModelConfig:
    """A dict of ModelConfig fields (``attn`` a dict of AttnConfig's), or
    the name of a smoke config."""
    if isinstance(spec, dict):
        spec = dict(spec)
        if isinstance(spec.get("attn"), dict):
            spec["attn"] = AttnConfig(**spec["attn"])
        return ModelConfig(**spec)
    return get_smoke(spec)


def train_config(tc: dict) -> ttl.TrainConfig:
    tc = dict(tc)
    return ttl.TrainConfig(adamw=topt.AdamWConfig(**tc.pop("adamw")), **tc)


def whole(tree):
    """The reference's layout of a tree of DTensors: every rank's blocks
    at their global indices (``elastic.shard_entries``, host copies)
    exchanged as objects and assembled, apart from the collectives under
    test."""
    mine = map_leaves(lambda key, b, t: list(shard_entries(t)), tree)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return params_to_jax(map_leaves(
        lambda key, b, t, *ranks: torch.from_numpy(assemble(
            tuple(t.shape), ranks[0][0][1].dtype,
            [e for entries in ranks for e in entries])),
        tree, *every))


def batch_of(b: dict, device) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in b.items()}


def step_case(c, mesh, work):
    cfg, tc = config(c["cfg"]), train_config(c["tc"])
    device = mesh.device_type
    params, opt, err = ttl.shard_state(
        params_from_jax(c["params"], device=device), None, tc, mesh)
    step = ttl.make_train_step(cfg, tc, mesh)
    out = {"loss": [], "grad_norm": []}
    for i, b in enumerate(c["batches"]):
        params, opt, err, m = step(params, opt, err, batch_of(b, device))
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
        if i == 0:
            out["params"], out["mu"] = whole(params), whole(opt["mu"])
            if tc.compress_grads:
                out["err"] = whole(err)
    return out


def train_case(c, mesh, work):
    """The uninterrupted run, then a run stopped at ``stop`` and
    restarted from its checkpoint; each saves its end state."""
    cfg, tc = config(c["cfg"]), train_config(c["tc"])
    data = SyntheticLM(DataConfig(**c["data"]))
    steps, stop = c["steps"], c["stop"]

    def run(ckpt, n):
        return ttl.train(cfg, tc, data, steps=n, mesh=mesh, device="cpu",
                         params=params_from_jax(c["params"], device="cpu"),
                         ckpt_mgr=CheckpointManager(f"{work}/{ckpt}"),
                         ckpt_every=stop, log_every=0)["loss"]
    whole_run = run("uninterrupted", steps)
    first = run("restarted", stop)
    rest = run("restarted", steps)
    ends = [CheckpointManager(f"{work}/{d}").restore_host(steps)[0]
            for d in ("uninterrupted", "restarted")]
    return {"uninterrupted": whole_run, "restarted": first + rest,
            "ends": ends}


def psum_case(c, mesh, work):
    r = dist.get_rank()
    grads = {k: torch.from_numpy(v[r]) for k, v in c["grads"].items()}
    err = {k: torch.from_numpy(v[r]) for k, v in c["err"].items()}
    out, new_err = compressed_psum(grads, err, "data", mesh=mesh)
    return {"out": {k: v.numpy() for k, v in out.items()},
            "err": {k: v.numpy() for k, v in new_err.items()}}


def pipeline_case(c, mesh, work):
    s = mesh.get_local_rank("pipe")
    ws = torch.from_numpy(c["ws"])

    def stage(p, a):
        return torch.tanh(a @ p["w"])
    got = pipeline_apply(stage, {"w": ws[s:s + 1]}, torch.from_numpy(c["x"]),
                         mesh=mesh, n_microbatches=c["x"].shape[0])
    return got.numpy()


def layout_case(c, mesh, work):
    """The shapes a rank holds of layer ``c["layer"]`` and the shapes it
    computes with (``Layout.layer``), whether the mixer and the FFN run
    tensor- (or expert-) parallel, and the bytes the mixer's and the
    FFN's gathers move by kind."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import parallel, sharding
    from repro_torch.models import transformer as tfm
    cfg = config(c["cfg"])
    params = sharding.shard_params(params_from_jax(c["params"],
                                                   device="cpu"), mesh)
    lay = parallel.Layout(cfg, mesh, sharding.param_specs(params, mesh),
                          parallel.shapes_of(params))
    local = sharding.local_blocks(params)
    prefix, period = cfg.segmentation()
    i = c["layer"]
    where = (("prefix", i) if i < prefix
             else ("body", (i - prefix) % period, (i - prefix) // period))
    lp = tfm.layer_params(local, cfg, i)
    used, tp_mix, tp_ffn = lay.layer(lp, where, i)
    computed = mixer_shapes(cfg, cfg.mixers[i], used["mix"], tp_mix)
    moved = {}
    for part in ("mix", "ffn"):
        coll.TRAFFIC.reset()
        lay.layer({part: lp[part]}, where, i)
        moved[part] = {k: v["bytes"]
                       for k, v in coll.TRAFFIC.by_kind().items()}
    shapes = lambda tree: {p: {k: list(v.shape) for k, v in d.items()}
                           for p, d in tree.items()}
    out = {"held": shapes(lp), "compute": shapes(used),
           "tp": [tp_mix is not None, tp_ffn is not None],
           "mixer": computed, "mix_bytes": moved["mix"],
           "ffn_bytes": moved["ffn"]}
    if cfg.enc_dec:
        enc, tp_enc, tp_enc_ffn = lay.encoder_layer(local["encoder"][0], 0)
        out["encoder"] = {
            "held": shapes(local["encoder"][0]), "compute": shapes(enc),
            "tp": [tp_enc is not None, tp_enc_ffn is not None],
            "mixer": mixer_shapes(cfg, "attn", enc["mix"], tp_enc)}
    return out


def mixer_shapes(cfg, mix, params, tp) -> dict:
    """What the mixer computes from ``params`` (``Layout.layer``'s) on a
    (1, 4, D) input under ``tp``: attention's and MLA's query (and KV)
    heads, Mamba's and RWKV-6's output and recurrent state (its
    channels or heads)."""
    from repro_torch.models import attention, mamba, mla, rwkv6
    x = torch.randn(1, 4, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    pos = torch.arange(4)[None]
    if mix == "attn":
        q, k, v = attention.qkv_proj(params, x, cfg, pos, tp)
        out = {"q": q, "k": k, "v": v}
    elif mix == "mla":
        out = dict(zip(("q_nope", "q_rope"),
                       mla._project_q(params, x, cfg, pos, tp)))
    elif mix == "mamba":
        y, (_, h) = mamba.mamba_mix(params, x, cfg, tp=tp)
        out = {"y": y, "state": h}
    else:
        y, (_, st) = rwkv6.rwkv6_mix(params, x, cfg, tp=tp)
        out = {"y": y, "state": st}
    return {k: list(v.shape) for k, v in out.items()}


def serve_case(c, mesh, work):
    from _torch_serve_ranks import serve_case as serve
    return serve(c, mesh, work)


RUNNERS = {"step": step_case, "train": train_case, "psum": psum_case,
           "pipeline": pipeline_case, "layout": layout_case,
           "serve": serve_case}
#: the kinds whose values every rank returns (the others: rank 0 alone)
PER_RANK = ("psum", "layout", "serve")


def main() -> None:
    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    with open(f"{work}/inputs.pkl", "rb") as f:
        cases = pickle.load(f)
    device = cases.pop("device", "cpu")
    if device == "cuda":                    # every rank on the one card
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    meshes = {}
    results = {}
    for name, c in cases.items():
        shape = tuple(c["mesh"])
        if shape not in meshes:              # every rank builds each once
            meshes[shape] = (DeviceMesh(device, torch.arange(world),
                                        mesh_dim_names=("pipe",))
                             if shape == ("pipe",)
                             else make_host_mesh(*shape, device_type=device))
        try:
            value = RUNNERS[c["kind"]](c, meshes[shape], f"{work}/{name}")
            results[name] = {"ok": True, "value": value
                             if rank == 0 or c["kind"] in PER_RANK else None}
        except Exception:
            results[name] = {"ok": False, "error": traceback.format_exc()}
    with open(f"{work}/result_{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
