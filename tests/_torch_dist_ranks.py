"""One rank of the port's multi-process checks.  No JAX here.

    python tests/_torch_dist_ranks.py RANK WORLD WORKDIR
    python tests/_torch_dist_ranks.py cuda RANK WORLD WORKDIR

The first form is one of the four ranks ``tests/test_torch_distributed.py``
starts: the parent test computed the reference's answers and pickled them
beside the inputs, and every rank runs every check on its own shards of a
(data 2, model 2) CPU mesh.  The second is one of the two ranks
``tests/test_torch_kernels_cuda.py`` starts on one GPU: the SP decode on
a (data 1, model 2) mesh of CUDA tensors against the single-device
kernel's output, saved by the parent.  Every rank joins a gloo process
group through a file under WORKDIR and writes ``result_<rank>.json``: per
check ``"ok"`` or the traceback, and for the decode checks a digest of
the rank's logits (every rank must hold the same ones).  Each check
finishes its collectives before it compares, so a wrong answer on one
rank does not leave the others waiting.
"""

from __future__ import annotations

import hashlib
import json
import pickle
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.bridge import params_from_jax
from repro_torch.configs import deepseek_moe_16b as tdsm
from repro_torch.configs import deepseek_v2_236b as tdsv2
from repro_torch.distributed.collectives import (
    axis_size, gather_batch, local_shard, local_state, mla_decode_sp,
    paged_decode_attention_sp, scatter_seq_sp, vocab_parallel_embed,
    vocab_shard)
from repro_torch.distributed.elastic import shard_index
from repro_torch.distributed.sharding import (P, decode_axes, expert_shards,
                                              to_placements)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import CheckpointManager

TOL = dict(rtol=2e-5, atol=2e-5)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), want, **(tol or TOL))


def placement_order(mesh, inp, work):
    """A dim split over ("data", "model") splits row-major: partition
    p = data · n_model + model, in DTensor, local_shard and shard_index
    alike; the other order is refused."""
    x = torch.arange(48.0).reshape(16, 3)
    spec = P(("data", "model"), None)
    dt = distribute_tensor(x, mesh, to_placements(spec, mesh),
                           src_data_rank=None)
    p = mesh.get_local_rank("data") * 2 + mesh.get_local_rank("model")
    want = x[p * 4:(p + 1) * 4]
    assert torch.equal(dt.to_local(), want)
    assert torch.equal(local_shard(x, spec, mesh), want)
    assert shard_index(x.shape, dt.placements, mesh.get_coordinate(),
                       mesh.shape) == ((p * 4, p * 4 + 4), (0, 3))
    try:
        to_placements(P(("model", "data"), None), mesh)
    except ValueError:
        return
    raise AssertionError("to_placements took a dim split out of mesh order")


def sp_decode(case):
    def check(mesh, inp, work):
        c = inp["sp"][case]
        ba, sa = c["ba"], c["sa"]
        opt = c["opt"]
        B = c["q"].shape[0]
        out = paged_decode_attention_sp(
            local_shard(t(c["q"]), (ba,), mesh),
            local_shard(t(c["kp"]), (ba + sa,), mesh),
            local_shard(t(c["vp"]), (ba + sa,), mesh),
            local_shard(t(c["tables"]), (ba, sa if opt else None), mesh),
            local_shard(t(c["lengths"]), (ba,), mesh), mesh=mesh,
            batch_axes=ba, seq_axes=sa, window=c["window"],
            table_cols_sharded=opt)
        close(gather_batch(out, mesh, ba, B), c["want"])
    return check


def mla_sp(case):
    def check(mesh, inp, work):
        c = inp["mla"][case]
        ba, sa = ("data",), ("model",)
        lp = {k: t(v) for k, v in inp["mla"]["params"].items()}
        B = c["x"].shape[0]

        def rows(a):
            return local_shard(t(a), (ba,), mesh)
        out = mla_decode_sp(
            lp, rows(c["x"]), rows(c["positions"]),
            local_shard(t(c["c_pool"]), (ba + sa,), mesh),
            local_shard(t(c["rope_pool"]), (ba + sa,), mesh),
            local_shard(t(c["tables"]), (ba, sa if c["opt"] else None),
                        mesh),
            rows(c["lengths"]), tdsv2.smoke(), mesh=mesh, batch_axes=ba,
            seq_axes=sa, table_cols_sharded=c["opt"])
        close(gather_batch(out, mesh, ba, B), c["want"])
    return check


def vocab_embed(mesh, inp, work):
    """Tokens' rows over "data", the table's V rows over "model" (V odd:
    a short last shard); the table shard's gradient, summed over the data
    ranks as data parallelism sums it, is its rows of the reference's."""
    c = inp["vocab"]
    V = c["table"].shape[0]
    shard = vocab_shard(t(c["table"]), mesh).clone().requires_grad_()
    toks = local_shard(t(c["tokens"]), (("data",),), mesh)
    x = vocab_parallel_embed(toks, shard, mesh=mesh, vocab=V)
    (x ** 2).sum().backward()
    grad = shard.grad.clone()
    dist.all_reduce(grad, group=mesh.get_group("data"))
    Vl = -(-V // 2)
    lo = mesh.get_local_rank("model") * Vl
    want_x = local_shard(t(c["want"]), (("data",),), mesh).numpy()
    close(x, want_x, rtol=1e-6, atol=1e-6)
    close(grad, c["grad"][lo:lo + Vl], rtol=1e-6, atol=1e-6)


def scatter(case):
    def check(mesh, inp, work):
        c = inp["scatter"][case]
        ba, sa = c["ba"], c["sa"]
        pool = local_shard(t(c["pool"]), (ba + sa,), mesh).clone()
        scatter_seq_sp(pool, local_shard(t(c["seq"]), (ba,), mesh),
                       local_shard(t(c["tab"]), (ba,), mesh), mesh=mesh,
                       batch_axes=ba, seq_axes=sa)
        want = local_shard(t(c["want"]), (ba + sa,), mesh)
        assert torch.equal(pool, want), "scatter_seq_sp differs"
    return check


SMOKES = {"deepseek-v2-smoke": tdsv2.smoke, "deepseek-moe-smoke": tdsm.smoke}


def serve(c, cfg, params, mesh) -> torch.Tensor:
    """``prefill(mesh=)`` of the case's prompt (in its ``moe_groups``)
    then greedy ``decode_step(page_impl=c["impl"])`` steps: the stacked
    logits."""
    prompt = t(c["prompt"])
    B = prompt.shape[0]
    ba, sa = decode_axes(mesh, batch=B)
    st = tfm.init_decode_state(
        cfg, B, c["max_len"], batch_shards=axis_size(mesh, ba),
        seq_shards=axis_size(mesh, sa), device="cpu")
    st = local_state(st, cfg, mesh, batch_axes=ba, seq_axes=sa)
    kw = dict(mesh=mesh, batch_axes=ba, seq_axes=sa)
    logits, st = tfm.prefill(params, cfg, prompt, st,
                             moe_groups=c.get("moe_groups", 1), **kw)
    got = [logits]
    for _ in range(len(c["logits"]) - 1):
        tok = logits.argmax(-1).to(torch.int32)
        logits, st = tfm.decode_step(params, cfg, st, tok,
                                     page_impl=c["impl"], **kw)
        got.append(logits)
    return torch.stack(got)


def case_config(c) -> ModelConfig:
    return (SMOKES[c["cfg"]]() if isinstance(c["cfg"], str)
            else ModelConfig(**c["cfg"]))


def decode(case):
    def check(mesh, inp, work):
        c = inp["decode"][case]
        cfg = case_config(c)
        got = serve(c, cfg, params_from_jax(c["params"], device="cpu"), mesh)
        toks = got.argmax(-1).numpy()
        np.testing.assert_array_equal(toks, c["logits"].argmax(-1))
        close(got, c["logits"], rtol=1e-5, atol=1e-5)
        return hashlib.sha256(got.numpy().tobytes()).hexdigest()
    return check


def expert_blocks(case):
    """The case served from this rank's expert blocks
    (``sharding.expert_shards``, the whole stacks dropped) gives the
    logits of the whole stacks, bit for bit."""
    def check(mesh, inp, work):
        c = inp["decode"][case]
        cfg = case_config(c)
        whole = serve(c, cfg, params_from_jax(c["params"], device="cpu"),
                      mesh)
        params = expert_shards(params_from_jax(c["params"], device="cpu"),
                               cfg, mesh)
        E, n = cfg.moe.num_experts, axis_size(mesh, ("model",))
        for i in range(cfg.n_layers):
            ffn = tfm.layer_params(params, cfg, i)["ffn"]
            if cfg.ffns[i] == "moe":
                assert ffn["w_gate"].shape[0] == E // n, ffn["w_gate"].shape
                assert ffn["w_gate"].is_contiguous()
        assert torch.equal(serve(c, cfg, params, mesh), whole)
    return check


def loss(mesh, inp, work):
    """The tiny tied model's ``loss_fn(mesh=)`` (whole batch on every
    rank) and the gradient of the rank's V rows of its embedding, which
    the tied unembedding and the vocab-parallel lookup both feed (the
    rank owns those rows, as under ``P("model", None)``)."""
    c = inp["loss"]
    cfg = ModelConfig(**inp["decode"]["tiny_sp"]["cfg"])
    params = params_from_jax(c["params"], device="cpu")
    params["embed"].requires_grad_()
    batch = {k: t(v) for k, v in c["batch"].items()}
    value = tfm.loss_fn(params, cfg, batch, mesh=mesh)
    value.backward()
    np.testing.assert_allclose(value.item(), c["loss"], rtol=1e-5)
    rows = vocab_shard(torch.arange(cfg.vocab), mesh)
    close(params["embed"].grad[rows], c["grad"][rows.numpy()], rtol=1e-5,
          atol=1e-5)


def elastic(mesh, inp, work):
    """Save on (2, 2) with w: P("data", "model"), b: P("model"); restore
    onto (1, 4) and (4, 1) with w: P("model", "data"), bit-exact; and the
    reference's checkpoint of a (4, 2) mesh onto (2, 2)."""
    w, b = torch.arange(64.0).reshape(8, 8), torch.arange(8.0)
    tree = {k: distribute_tensor(v, mesh, to_placements(s, mesh),
                                 src_data_rank=None)
            for k, v, s in (("w", w, P("data", "model")),
                            ("b", b, P("model")))}
    mgr = CheckpointManager(f"{work}/ckpt", keep=1)
    mgr.save(1, tree)
    like = {"w": w, "b": b}
    for shape in ((1, 4), (4, 1)):
        m2 = make_host_mesh(*shape, device_type="cpu")
        back = mgr.restore(1, like, mesh=m2,
                           specs={"w": P("model", "data"), "b": P(None)})
        for k in like:
            d = back[k]
            assert isinstance(d, DTensor), type(d)
            assert torch.equal(d.full_tensor(), like[k]), (shape, k)
            idx = shard_index(d.shape, d.placements, m2.get_coordinate(),
                              m2.shape)
            sl = tuple(slice(a, z) for a, z in idx)
            assert torch.equal(d.to_local(), like[k][sl]), (shape, k)
    ref = CheckpointManager(f"{work}/ref_ckpt").restore(
        1, like, mesh=mesh, specs={"w": P("data", "model"), "b": P("model")})
    for k, want in inp["elastic_ref"].items():
        assert np.array_equal(ref[k].full_tensor().numpy(), want), k


def checks(inp) -> list:
    out = [("placement_order", placement_order), ("vocab_embed", vocab_embed),
           ("loss", loss), ("elastic", elastic)]
    out += [(f"sp_decode/{c}", sp_decode(c)) for c in inp["sp"]]
    out += [(f"mla_sp/{c}", mla_sp(c)) for c in inp["mla"] if c != "params"]
    out += [(f"scatter/{c}", scatter(c)) for c in inp["scatter"]]
    out += [(f"decode/{c}", decode(c)) for c in inp["decode"]]
    out += [(f"expert_blocks/{c}", expert_blocks(c))
            for c in inp["expert_blocks"]]
    return out


def spawn(work, world: int, *args, timeout: float = 240,
          script: str | None = None, then=None) -> list:
    """Start ``world`` ranks of ``script`` (default: this one; ``[*args,
    rank, world, work]``), logs under ``work``; call ``then()`` if given
    (work of the parent's that overlaps the ranks'); wait until all exit,
    one exits non-zero (the others would wait in a collective) or
    ``timeout`` passes, then stop any still running.  Returns (exit
    codes, None for a rank stopped, and each rank's log)."""
    import os
    import subprocess
    import time
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "..", "src"))
    env.pop("XLA_FLAGS", None)
    logs = [open(f"{work}/rank_{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, script or os.path.abspath(__file__), *args, str(r),
         str(world), str(work)], env=env, stdout=log,
        stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        if then is not None:
            then()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    return [(c, open(f"{work}/rank_{r}.log").read())
            for r, c in enumerate(codes)]


def cuda_sp(case):
    def check(mesh, inp, work):
        c = inp[case]
        sa = ("model",)
        k, v = attn_mod.split_fused_kv(local_shard(c["kv"], (sa,), mesh))
        tables = c["tables"]
        if case == "sp_opt":
            tables = local_shard(tables, (None, sa), mesh)
        got = paged_decode_attention_sp(
            c["q"], k, v, tables, c["lengths"], mesh=mesh, batch_axes=(),
            seq_axes=sa, table_cols_sharded=case == "sp_opt")
        close(got.cpu(), c["want"].cpu().numpy())
    return check


def run(rank, world, work, mesh_shape, device_type, load, checks) -> None:
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    inp = load()
    mesh = make_host_mesh(*mesh_shape, device_type=device_type)
    results = {}
    for name, check in checks(inp):
        try:
            results[name] = {"ok": True, "value": check(mesh, inp, work)}
        except Exception:
            results[name] = {"ok": False, "error": traceback.format_exc()}
    with open(f"{work}/result_{rank}.json", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def main() -> None:
    torch.set_num_threads(1)
    if sys.argv[1] == "cuda":
        rank, world, work = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
        torch.cuda.set_device(0)
        run(rank, world, work, (1, 2), "cuda",
            lambda: {k: {n: x.cuda() for n, x in c.items()}
                     for k, c in torch.load(f"{work}/case.pt").items()},
            lambda inp: [(f"cuda_sp/{c}", cuda_sp(c)) for c in inp])
        return
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    def load():
        with open(f"{work}/inputs.pkl", "rb") as f:
            return pickle.load(f)
    run(rank, world, work, (2, 2), "cpu", load, checks)


if __name__ == "__main__":
    main()
