"""The port's training on a device mesh against the reference's step, on
four gloo CPU ranks.

``make_train_step(cfg, tc, mesh)`` on (data 2, model 2) and (data 4,
model 1) meshes, for the tiny tied decoder and the DeepSeek-MoE smoke
config routing in 1 and 2 groups, against the reference's single-device
step (GSPMD changes placement, never math: the reference's own check
compares its mesh step with it): loss and grad norm within 1e-5
relative, the first moments (the clipped gradient) and the new params
within 1e-5 of each leaf's max (``assert_step_close`` says where Adam's
first step amplifies f32 noise), two microbatches against the
reference's microbatched step, a 3-step trajectory within 1e-4, and a
compressed step within one int8 quantum.  Also ``train(mesh=)``
restarted from its sharded checkpoint against the uninterrupted run
(bit-exact), ``compressed_psum`` against the reference's under
``shard_map`` on 4 fake devices (1e-6), and ``pipeline_apply`` on a
("pipe",) mesh of 4 ranks against the reference's (1e-5).  The Jamba
smoke config is ``tests/test_torch_train_mesh_hybrid.py``'s.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro.training.data import DataConfig, SyntheticLM  # noqa: E402
from _train_mesh_cases import (  # noqa: E402
    CONFIGS, LR, MESHES, assert_int8_close, assert_leaves_close,
    assert_step_close, jcfg, reference_steps, run_ranks, step_cases,
    train_config, value)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
VARIANTS = [("tiny", 1), ("deepseek-moe-16b", 1), ("deepseek-moe-16b", 2)]
TRAIN = dict(steps=4, stop=2, data=dict(vocab=61, seq_len=16,
                                        global_batch=8))

#: the reference's ``compressed_psum`` under ``shard_map`` and its
#: ``pipeline_apply`` (4 stages), on 4 fake devices
_REF_COLLECTIVES = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed._compat import shard_map
from repro.distributed.pipeline import pipeline_apply
from repro.launch.mesh import mesh_axis_kwargs
from repro.training.grad_compression import compressed_psum
with open(sys.argv[1], "rb") as f:
    c = pickle.load(f)
mesh = jax.make_mesh((4,), ("data",), **mesh_axis_kwargs(1))
def body(g, e):
    g, e = jax.tree.map(lambda t: t[0], (g, e))
    out, ne = compressed_psum(g, e, "data")
    return jax.tree.map(lambda t: t[None], (out, ne))
psum = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                 out_specs=(P("data"), P("data")))
out, err = jax.jit(psum)(c["grads"], c["err"])
pmesh = jax.make_mesh((4,), ("pipe",), **mesh_axis_kwargs(1))
with pmesh:
    pipe = pipeline_apply(lambda p, a: jnp.tanh(a @ p["w"]), {"w": c["ws"]},
                          jnp.asarray(c["x"]), mesh=pmesh,
                          n_microbatches=c["x"].shape[0])
with open(sys.argv[2], "wb") as f:
    pickle.dump({"out": jax.tree.map(np.asarray, out),
                 "err": jax.tree.map(np.asarray, err),
                 "pipeline": np.asarray(pipe)}, f)
"""


def _collective_inputs() -> dict:
    rng = np.random.RandomState(11)
    grads = {"a": rng.randn(4, 8, 16).astype(np.float32),
             "b": (rng.randn(4, 33) * 1e-3).astype(np.float32)}
    err = {k: (rng.randn(*v.shape) * 1e-3).astype(np.float32)
           for k, v in grads.items()}
    ks = jax.random.split(jax.random.PRNGKey(2), 4)
    ws = np.stack([np.asarray(jax.random.normal(k, (16, 16))) * 0.3
                   for k in ks]).astype(np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4, 2, 16)),
                   np.float32)
    return dict(grads=grads, err=err, ws=ws, x=x)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_mesh")
    cases = {}
    for i, (name, g) in enumerate(VARIANTS):
        cases.update(step_cases(name, CONFIGS[name], seed=20 + i,
                                groups=(g,), compress=name == "tiny"))
    tiny = next(c for c in cases.values() if c["cfg"] == CONFIGS["tiny"])
    cases["train-2x2"] = dict(kind="train", cfg=CONFIGS["tiny"],
                              params=tiny["params"], tc=train_config(),
                              mesh=(2, 2), **TRAIN)
    coll = _collective_inputs()
    cases["psum"] = dict(kind="psum", mesh=(4, 1), grads=coll["grads"],
                         err=coll["err"])
    cases["pipeline"] = dict(kind="pipeline", mesh=("pipe",), ws=coll["ws"],
                             x=coll["x"])
    for name, layer in (("tiny", 0), ("deepseek-moe-16b", 1)):
        c = next(c for c in cases.values() if c.get("cfg") == CONFIGS[name])
        cases[f"layout-{name}"] = dict(kind="layout", cfg=CONFIGS[name],
                                       params=c["params"], layer=layer,
                                       mesh=(2, 2))

    def reference():
        with open(work / "coll_in.pkl", "wb") as f:
            pickle.dump(coll, f)
        env = dict(os.environ, PYTHONPATH=SRC)
        env.pop("XLA_FLAGS", None)
        sub = subprocess.Popen([sys.executable, "-c", _REF_COLLECTIVES,
                                str(work / "coll_in.pkl"),
                                str(work / "coll_out.pkl")], env=env,
                               stderr=subprocess.PIPE, text=True)
        out = reference_steps(cases)
        out["trajectory"] = _reference_train(tiny)
        _, errs = sub.communicate(timeout=200)
        assert sub.returncode == 0, errs
        with open(work / "coll_out.pkl", "rb") as f:
            out["collectives"] = pickle.load(f)
        return out
    return run_ranks(work, cases, reference)


def _reference_train(tiny) -> list:
    """The reference's losses over ``train``'s batches (its data pipeline
    as the port's, a pure function of the step)."""
    cfg = jcfg(CONFIGS["tiny"])
    tc = jtl.TrainConfig(adamw=jopt.AdamWConfig(lr=LR, warmup_steps=1))
    step = jtl.make_train_step(cfg, tc, None, donate=False)
    data = SyntheticLM(DataConfig(**TRAIN["data"]))
    p = jax.tree.map(jnp.asarray, tiny["params"])
    opt, err, losses = jopt.init_opt_state(p), jnp.zeros(()), []
    for s in range(TRAIN["steps"]):
        p, opt, err, m = step(p, opt, err, {k: jnp.asarray(v) for k, v in
                                            data.batch(s).items()})
        losses.append(float(m["loss"]))
    return losses


def _ids(cases):
    return [f"{n}-g{g}-{m[0]}x{m[1]}" for n, g in cases for m in MESHES]


PAIRS = [(v, m) for v in VARIANTS for m in MESHES]


def _case(ranks, variant, mesh, run):
    name, g = variant
    key = f"{name}-g{g}-{run}-{mesh[0]}x{mesh[1]}"
    return value(ranks[0], key), ranks[2][(name, g, run)]


@pytest.mark.parametrize("variant,mesh", PAIRS, ids=_ids(VARIANTS))
def test_mesh_step_matches_reference(ranks, variant, mesh):
    """One step: loss and grad norm within 1e-5 relative, first moments
    and params within 1e-5 of each leaf's max."""
    got, want = _case(ranks, variant, mesh, "steps")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    assert_leaves_close(got["mu"], want["mu"])
    assert_step_close(got, want)


@pytest.mark.parametrize("variant,mesh", PAIRS, ids=_ids(VARIANTS))
def test_mesh_trajectory_matches_reference(ranks, variant, mesh):
    got, want = _case(ranks, variant, mesh, "steps")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)


@pytest.mark.parametrize("variant,mesh", PAIRS, ids=_ids(VARIANTS))
def test_mesh_microbatched_step_matches_reference(ranks, variant, mesh):
    """Microbatch i is rows [i·B/2, (i+1)·B/2) of the global batch, split
    over the data ranks, not a microbatch of a rank's rows."""
    got, want = _case(ranks, variant, mesh, "microbatches")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    assert_leaves_close(got["mu"], want["mu"])
    assert_step_close(got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_compressed_step_within_one_int8_quantum(ranks, mesh):
    """One scale per whole leaf (a MAX over the ranks): the moments and
    the error state within one int8 quantum of the reference's."""
    got, want = _case(ranks, ("tiny", 1), mesh, "compressed")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    scale = jax.tree.map(lambda m: np.abs(m).max() / 12.7, want["mu"])
    assert_int8_close(got["mu"], want["mu"],
                      jax.tree.map(lambda s: 0.1 * s, scale))
    assert_int8_close(got["err"], want["err"], scale)
    assert_step_close(got, want)


def test_train_restarts_from_a_sharded_checkpoint(ranks):
    """``train(mesh=)`` stopped after 2 of 4 steps and restarted from its
    per-shard checkpoint equals the uninterrupted run, bit for bit, whose
    losses are the reference's within 1e-4."""
    got = value(ranks[0], "train-2x2")
    assert got["restarted"] == got["uninterrupted"]
    a, b = got["ends"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(got["uninterrupted"], ranks[2]["trajectory"],
                               rtol=1e-4)


def test_compressed_psum_matches_reference(ranks):
    """Each rank's summed gradients and new error state within 1e-6 of
    the reference's device of the same index."""
    want = ranks[2]["collectives"]
    for r, res in enumerate(ranks[1]):
        got = value(res, "psum")
        for k in ("out", "err"):
            for leaf in got[k]:
                np.testing.assert_allclose(got[k][leaf], want[k][leaf][r],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"rank {r} {k}/{leaf}")


def test_pipeline_apply_matches_reference(ranks):
    """4 stages, 4 microbatches: the reference's ``pipeline_apply`` and
    the sequential application, within 1e-5."""
    got = value(ranks[0], "pipeline")
    np.testing.assert_allclose(got, ranks[2]["collectives"]["pipeline"],
                               rtol=1e-5, atol=1e-5)
    inp = _collective_inputs()
    want = inp["x"]
    for s in range(4):
        want = np.tanh(want @ inp["ws"][s])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,layer", [("tiny", 0),
                                        ("deepseek-moe-16b", 1)])
def test_mesh_holds_shards_and_computes_tensor_parallel(ranks, name, layer):
    """On (data 2, model 2) a rank holds its block of each leaf under
    ``param_specs``; attention and the dense FFN compute on the rank's
    H/2 heads' columns and F/2 rows (gathered over data only), an MoE
    layer on its E/2 experts and the shared experts' column and row
    blocks (expert parallel)."""
    got = value(ranks[0], f"layout-{name}")
    cfg = jcfg(CONFIGS[name])
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    held, used = got["held"], got["compute"]
    assert held["mix"]["wq"] == [D // 2, H * hd // 2]
    assert held["mix"]["wo"] == [H * hd // 2, D // 2]
    assert used["mix"]["wq"] == [D, H // 2 * hd]
    assert used["mix"]["wk"] == [D, KV // 2 * hd]
    assert used["mix"]["wo"] == [H // 2 * hd, D]
    assert got["tp"] == [True, True]
    if cfg.ffns[layer] == "dense":
        F = cfg.dense_d_ff or cfg.d_ff
        assert used["ffn"]["w_gate"] == [D, F // 2]
        assert used["ffn"]["w_down"] == [F // 2, D]
    else:
        E, de = cfg.moe.num_experts, cfg.moe.d_expert
        ds = de * cfg.moe.num_shared
        assert held["ffn"]["w_gate"] == [E // 2, D // 2, de]
        for k in ("w_gate", "w_up"):
            assert used["ffn"][k] == [E // 2, D, de]
        assert used["ffn"]["w_down"] == [E // 2, de, D]
        for k in ("s_gate", "s_up"):
            assert used["ffn"][k] == [D, ds // 2]
        assert used["ffn"]["s_down"] == [ds // 2, D]
        assert used["ffn"]["router"] == [D, E]


def test_moe_layer_gathers_only_the_ranks_experts(ranks):
    """On (data 2, model 2) the MoE layer's FFN gathers, over data only,
    the rank's E/2 experts, its shared-expert blocks and the router: its
    all-gather payload is those tensors' bytes, half the experts' whole
    bytes plus the router's, and nothing else moves."""
    got = value(ranks[0], "layout-deepseek-moe-16b")
    cfg = jcfg(CONFIGS["deepseek-moe-16b"])
    D, E, de = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    ds = de * cfg.moe.num_shared
    experts = 3 * E * D * de + 3 * D * ds
    assert got["ffn_bytes"] == {"all-gather": 4 * (experts // 2 + D * E)}
