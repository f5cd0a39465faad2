"""The port's training stack against the reference's on the CPU, f32:
``adamw_update`` (the decay rule by stacked ndim), int8 gradient
compression (one scale per stacked leaf) and its error feedback, one
``make_train_step`` step (microbatched and compressed too), a 10-step
``train`` loss trajectory, and checkpoints that each package writes and
the other restores.  Parameters are made on the reference side and
bridged; data comes from the shared ``SyntheticLM``."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.configs import deepseek_moe_16b as jdsm  # noqa: E402
from repro.configs import whisper_small as jwh  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JCfg  # noqa: E402
from repro.models.config import MoEConfig as JMoE  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import grad_compression as jgc  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro.training.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.bridge import (leaves, params_from_jax,  # noqa: E402
                                params_to_jax, tree_map)
from repro_torch.configs import deepseek_moe_16b as tdsm  # noqa: E402
from repro_torch.configs import whisper_small as twh  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.config import ModelConfig as TCfg  # noqa: E402
from repro_torch.models.config import MoEConfig as TMoE  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import grad_compression as tgc  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402
from repro_torch.training.data import DataConfig as TDataConfig  # noqa: E402
from repro_torch.training.data import SyntheticLM as TSyntheticLM  # noqa: E402

#: the reference's training-test config (tests/test_training.py)
_CFG = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
            d_ff=64, vocab=64, head_dim=16)
JCFG, TCFG = JCfg(**_CFG), TCfg(**_CFG)
TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's tree functions jitted: eager they take seconds a call
_jadamw = jax.jit(jopt.adamw_update, static_argnums=3)
_jcompress = jax.jit(jgc.compress_tree)
#: a train step's new params: Adam's first update is lr·g/(|g| + eps), so
#: a gradient entry near eps moves its param by up to lr·(its relative
#: error); 1e-5 absolute at lr 1e-3
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, **tol):
    """``got`` (reference layout, NumPy) against ``want`` leaf by leaf."""
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(_np(want))[0]
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (path, g), (_, w) in zip(fg, fw):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **(tol or TOL))


def _with_prefix():
    """DeepSeek-MoE smoke at 10 layers with 4 small experts: layer 0
    dense is a prefix layer, layers 1-9 a body of 9 MoE blocks (no period
    up to 8 covers all ten)."""
    def cut(c, moe_config):
        return c.with_(n_layers=10, mixers=("attn",) * 10,
                       ffns=("dense",) + ("moe",) * 9,
                       moe=moe_config(num_experts=4, top_k=2, num_shared=1,
                                      d_expert=16))
    return cut(jdsm.smoke(), JMoE), cut(tdsm.smoke(), TMoE)


MODELS = {"prefix+body": _with_prefix,
          "encoder": lambda: (jwh.smoke(), twh.smoke())}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    jcfg, tcfg = MODELS[request.param]()
    assert jcfg.segmentation()[0] == (1 if request.param == "prefix+body"
                                      else 0)
    jp = _np(jtfm.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    return jcfg, tcfg, jp


def _random_like(tree, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (rng.randn(*a.shape) * scale).astype(np.float32), tree)


# -------------------------------------------------------------- optimizer ----
def test_adamw_update_matches_reference(model):
    """Two updates from zero moments with random gradients: params, both
    moments, step, grad_norm and lr."""
    _, _, jp = model
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, weight_decay=0.1)
    tcfg = topt.AdamWConfig(lr=1e-2, warmup_steps=3, weight_decay=0.1)
    jparams, jstate = jax.tree.map(jnp.asarray, jp), jopt.init_opt_state(jp)
    tparams = params_from_jax(jp, device="cpu")
    tstate = topt.init_opt_state(tparams)
    for seed in (1, 2):
        g = _random_like(jp, seed, scale=0.3)
        jparams, jstate, jm = _jadamw(
            jparams, jax.tree.map(jnp.asarray, g), jstate, cfg)
        tparams, tstate, tm = topt.adamw_update(
            tparams, params_from_jax(g, device="cpu"), tstate, tcfg)
        # a sum over every entry of the tree, in another order
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-7)
    _assert_trees_close(params_to_jax(tparams), jparams)
    _assert_trees_close(params_to_jax(tstate), jstate)
    assert tstate["step"].dtype == torch.int32 and tstate["step"].item() == 2


def test_decay_follows_the_stacked_ndim(model):
    """Zero gradients leave only the decay: body norms and biases (ndim 2
    once stacked) shrink, prefix, encoder and final norms (ndim 1) stay."""
    jcfg, _, jp = model
    tparams = params_from_jax(jp, device="cpu")
    before = params_to_jax(tparams)
    zeros = tree_map(torch.zeros_like, tparams)
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=1, weight_decay=0.1)
    after, _, _ = topt.adamw_update(tparams, zeros,
                                    topt.init_opt_state(tparams), cfg)
    after = params_to_jax(after)
    np.testing.assert_allclose(after["body"][0]["mix"]["norm"],
                               before["body"][0]["mix"]["norm"] * 0.9,
                               rtol=1e-6)
    np.testing.assert_array_equal(after["final_norm"], before["final_norm"])
    for lp_after, lp_before in zip(after["prefix"] + after.get("encoder", ()),
                                   before["prefix"] + before.get("encoder",
                                                                 ())):
        np.testing.assert_array_equal(lp_after["mix"]["norm"],
                                      lp_before["mix"]["norm"])
        np.testing.assert_array_equal(lp_after["ffn"]["norm"],
                                      lp_before["ffn"]["norm"])
    # and the reference agrees leaf by leaf
    jafter, _, _ = _jadamw(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.zeros_like, jp),
        jopt.init_opt_state(jp),
        jopt.AdamWConfig(lr=1.0, warmup_steps=1, weight_decay=0.1))
    _assert_trees_close(after, jafter)


def test_donated_update_writes_in_place_and_matches(model):
    _, _, jp = model
    g = params_from_jax(_random_like(jp, 3), device="cpu")
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1)
    a = params_from_jax(jp, device="cpu")
    b = params_from_jax(jp, device="cpu")
    ra, sa, _ = topt.adamw_update(a, g, topt.init_opt_state(a), cfg)
    sb = topt.init_opt_state(b)
    rb, sb2, _ = topt.adamw_update(b, g, sb, cfg, donate=True)
    assert all(x is y for x, y in zip(leaves(rb), leaves(b)))
    assert all(x is y for x, y in zip(leaves(sb2["mu"]), leaves(sb["mu"])))
    for x, y in zip(leaves(ra) + leaves(sa), leaves(rb) + leaves(sb2)):
        assert torch.equal(x, y)


# ------------------------------------------------------------ compression ----
def test_compression_matches_reference_per_stacked_leaf(model):
    """The body's blocks get gradients of different magnitudes, so one
    scale per block would differ from the reference's one per stack."""
    _, _, jp = model
    g = _random_like(jp, 4, scale=1e-3)
    g["body"] = tuple(jax.tree.map(
        lambda a: a * np.geomspace(1, 10, a.shape[0]).reshape(
            (-1,) + (1,) * (a.ndim - 1)).astype(np.float32), stack)
        for stack in g["body"])
    err = _random_like(jp, 5, scale=1e-5)
    (jq, js), jerr = _jcompress(jax.tree.map(jnp.asarray, g),
                                       jax.tree.map(jnp.asarray, err))
    (tq, ts), terr = tgc.compress_tree(params_from_jax(g, device="cpu"),
                                       params_from_jax(err, device="cpu"))
    for got, want in zip(jax.tree.leaves(params_to_jax(tq)),
                         jax.tree.leaves(jq)):
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, np.asarray(want))
    # each block of a body leaf carries the stack's one scale
    for stack in ts["body"]:
        for blk in stack[1:]:
            assert all(torch.equal(x, y)
                       for x, y in zip(leaves(blk), leaves(stack[0])))
    scales = params_to_jax(ts)
    scales["body"] = tuple(jax.tree.map(lambda a: a[0], s)
                           for s in scales["body"])
    # one ulp: jitted, XLA may divide by 127 as a multiply by 1/127
    _assert_trees_close(scales, js, rtol=2.5e-7, atol=0)
    # jitted, XLA fuses gf - q·scale into one FMA: the product's rounding,
    # up to ~4e-9 at the largest gradients here (~5e-2)
    _assert_trees_close(params_to_jax(terr), jerr, rtol=1e-6, atol=1e-8)
    _assert_trees_close(params_to_jax(tgc.decompress_tree((tq, ts))),
                        jgc.decompress_tree((jq, js)), rtol=2.5e-7, atol=0)


def test_grad_compression_error_feedback():
    """The port's twin of the reference's test: a gradient below one int8
    step alone averages out right over 50 steps."""
    err = tgc.init_error_state({"w": torch.ones(8, 8)})
    g = {"w": torch.full((8, 8), 0.001)}
    total = torch.zeros(8, 8)
    for _ in range(50):
        q, err = tgc.compress_tree(g, err)
        total = total + tgc.decompress_tree(q)["w"]
    np.testing.assert_allclose(total.mean().item() / 50, 0.001, rtol=0.05)


def test_compress_leaf_matches_reference():
    rng = np.random.RandomState(6)
    g, e = rng.randn(5, 7).astype(np.float32), rng.randn(5, 7).astype(
        np.float32) * 0.01
    jq, js, je = jgc.compress_leaf(jnp.asarray(g), jnp.asarray(e))
    tq, ts, te = tgc.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8
    np.testing.assert_allclose(ts.item(), float(js), rtol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-9)


# ------------------------------------------------------------- train step ----
def _tiny():
    jp = _np(jtfm.init_params(jax.random.PRNGKey(0), JCFG, jnp.float32))
    return jp, params_from_jax(jp, device="cpu")


def _data(batch=4, seq=32):
    return (SyntheticLM(DataConfig(vocab=64, seq_len=seq,
                                   global_batch=batch)),
            TSyntheticLM(TDataConfig(vocab=64, seq_len=seq,
                                     global_batch=batch)))


@pytest.mark.parametrize("kw", [{}, {"microbatches": 4},
                                {"compress_grads": True}],
                         ids=["plain", "microbatches-4", "compressed"])
def test_train_step_matches_reference(kw):
    """One step: loss, grad_norm, lr, new params and moments (and the
    error state when compressing) within 1e-5."""
    jp, tp = _tiny()
    jdata, tdata = _data(batch=8)
    batch = jdata.batch(0)
    jtc = jtl.TrainConfig(adamw=jopt.AdamWConfig(lr=1e-3, warmup_steps=1),
                          **kw)
    ttc = ttl.TrainConfig(adamw=topt.AdamWConfig(lr=1e-3, warmup_steps=1),
                          **kw)
    jstep = jtl.make_train_step(JCFG, jtc, None, donate=False)
    jerr = (jgc.init_error_state(jp) if jtc.compress_grads
            else jnp.zeros(()))
    jp2, jo2, je2, jm = jstep(jax.tree.map(jnp.asarray, jp),
                              jopt.init_opt_state(jp), jerr,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = ttl.make_train_step(TCFG, ttc)
    terr = (tgc.init_error_state(tp) if ttc.compress_grads
            else torch.zeros(()))
    tp2, to2, te2, tm = tstep(tp, topt.init_opt_state(tp), terr,
                              {k: torch.as_tensor(v)
                               for k, v in tdata.batch(0).items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5)
    _assert_trees_close(params_to_jax(tp2), jp2, **STEP_TOL)
    if ttc.compress_grads:
        # from zero moments mu = (1 - b1)·q·scale, so max|mu| = 12.7·scale
        scale = jax.tree.map(lambda m: np.abs(m).max() / 12.7, _np(jo2["mu"]))
        _assert_close_but_int8_flips(
            params_to_jax(to2), jo2,
            {"mu": jax.tree.map(lambda s: 0.1 * s, scale),
             "nu": jax.tree.map(lambda s: 0.05 * 255 * s * s, scale),
             "step": 0})
        _assert_close_but_int8_flips(params_to_jax(te2), je2, scale)
    else:
        _assert_trees_close(params_to_jax(to2), jo2)
    assert not any(t.requires_grad for t in leaves(tp2))


def _assert_close_but_int8_flips(got, want, bound, frac=2e-3):
    """Leaf by leaf within TOL, except at most ``frac`` of the entries,
    each within ``bound`` (a tree of one number per leaf) with 1% to
    spare.  Where g / scale lies on a rounding boundary, f32 noise in g
    picks the other int8 level: that moves the error state by one scale,
    and the first moments by (1 - b1)·scale and (1 - b2)·(2|q| + 1)·
    scale² ≤ 0.05·255·scale²."""
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(_np(want))[0]
    fb = jax.tree.leaves(bound)
    assert [p for p, _ in fg] == [p for p, _ in fw] and len(fb) == len(fw)
    for (path, g), (_, w), b in zip(fg, fw, fb):
        off = ~np.isclose(g, w, **TOL)
        name = jax.tree_util.keystr(path)
        assert off.sum() <= frac * off.size, (name, off.sum())
        assert np.all(np.abs(g - w)[off] <= 1.01 * b), name


def test_microbatched_equals_full_batch():
    """The port's twin of the reference's test (4 microbatches of 2 rows
    against one batch of 8), new params included.  The step averages the
    microbatches' mean losses, as the reference does, which equals the
    batch's mean only where every microbatch counts as many labels: so
    here only the last label of each row is masked."""
    _, tp = _tiny()
    _, tdata = _data(batch=8)
    tokens = torch.as_tensor(tdata.batch(0)["tokens"])
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -100
    batch = {"tokens": tokens, "labels": labels}
    outs = []
    for mb in (1, 4):
        tc = ttl.TrainConfig(microbatches=mb, adamw=topt.AdamWConfig(
            lr=1e-3, warmup_steps=1))
        p = tree_map(torch.clone, tp)
        p, _, _, m = ttl.make_train_step(TCFG, tc)(
            p, topt.init_opt_state(p), torch.zeros(()), batch)
        outs.append((m["loss"].item(), params_to_jax(p)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5)
    _assert_trees_close(outs[1][1], outs[0][1], **STEP_TOL)


def test_trained_params_are_plain_and_serve():
    """After a step the params require no grad and feed ``prefill`` and
    ``decode_step`` directly (finite logits)."""
    _, tp = _tiny()
    _, tdata = _data()
    tc = ttl.TrainConfig(adamw=topt.AdamWConfig(lr=1e-3, warmup_steps=1))
    p, _, _, _ = ttl.make_train_step(TCFG, tc)(
        tp, topt.init_opt_state(tp), torch.zeros(()),
        {k: torch.as_tensor(v) for k, v in tdata.batch(0).items()})
    assert not any(t.requires_grad or t.grad_fn for t in leaves(p))
    st = ttfm.init_decode_state(TCFG, 2, 64, device="cpu")
    tokens = torch.as_tensor(tdata.batch(1)["tokens"][:2, :16])
    logits, st = ttfm.prefill(p, TCFG, tokens, st)
    logits, st = ttfm.decode_step(p, TCFG, st, logits.argmax(-1).to(
        torch.int32))
    assert torch.isfinite(logits).all() and logits.shape == (2, 64)


def test_train_refuses_a_mesh():
    """A mesh must be a ``torch.distributed`` DeviceMesh (training on one
    is ``tests/test_torch_train_mesh.py``'s)."""
    tc = ttl.TrainConfig()
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttl.make_train_step(TCFG, tc, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttl.train(TCFG, tc, None, steps=1, mesh=object(), device="cpu")


# ------------------------------------------------------------ train driver ----
def test_train_trajectory_matches_reference():
    """10 steps of ``train`` from the same params: losses within 1e-4."""
    jp, tp = _tiny()
    jdata, tdata = _data()
    jtc = jtl.TrainConfig(adamw=jopt.AdamWConfig(lr=2e-3, warmup_steps=5))
    ttc = ttl.TrainConfig(adamw=topt.AdamWConfig(lr=2e-3, warmup_steps=5))
    jhist = jtl.train(JCFG, jtc, jdata, steps=10, log_every=0,
                      dtype=jnp.float32,
                      params=jax.tree.map(jnp.asarray, jp),
                      opt_state=jopt.init_opt_state(jp))
    thist = ttl.train(TCFG, ttc, tdata, steps=10, log_every=0,
                      params=tp, opt_state=topt.init_opt_state(tp))
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=1e-4)
    assert len(thist["step_time"]) == 10


def test_loss_decreases():
    _, tdata = _data()
    tc = ttl.TrainConfig(adamw=topt.AdamWConfig(lr=2e-3, warmup_steps=5))
    hist = ttl.train(TCFG, tc, tdata, steps=30, log_every=0,
                     dtype=torch.float32, device="cpu")
    first, last = np.mean(hist["loss"][:5]), np.mean(hist["loss"][-5:])
    assert last < first - 0.1, (first, last)


def test_non_finite_loss_raises():
    _, tp = _tiny()
    _, tdata = _data()
    tp["final_norm"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="step 0"):
        ttl.train(TCFG, ttl.TrainConfig(), tdata, steps=1, log_every=0,
                  params=tp, opt_state=topt.init_opt_state(tp))


# ------------------------------------------------------------- checkpoints ----
def _state_pair(seed=7):
    """A reference and a port training state with equal values: params and
    moments random, step 3."""
    jp = _np(jtfm.init_params(jax.random.PRNGKey(seed), JCFG, jnp.float32))
    jopt_state = {"mu": _random_like(jp, seed + 1),
                  "nu": _random_like(jp, seed + 2),
                  "step": np.asarray(3, np.int32)}
    jtree = {"params": jp, "opt": jopt_state}
    ttree = {"params": params_from_jax(jp, device="cpu"),
             "opt": {"mu": params_from_jax(jopt_state["mu"], device="cpu"),
                     "nu": params_from_jax(jopt_state["nu"], device="cpu"),
                     "step": torch.tensor(3, dtype=torch.int32)}}
    return jtree, ttree


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _state_pair()
    jckpt.CheckpointManager(str(tmp_path)).save(3, jtree)
    like = tree_map(torch.zeros_like, ttree)
    back = tckpt.CheckpointManager(str(tmp_path)).restore(3, like)
    for got, want in zip(leaves(back), leaves(ttree)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree, ttree = _state_pair(seed=8)
    tmgr = tckpt.CheckpointManager(str(tmp_path))
    tmgr.save(5, ttree, blocking=False)
    tmgr.wait()
    mgr = jckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 5
    back = mgr.restore(5, jtree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype
    flat, step = tckpt.CheckpointManager(str(tmp_path)).restore_host(5)
    assert step == 5 and flat["params/body/0/mix/wq"].shape == (2, 32, 32)
    assert set(flat) == set(jckpt._flatten(jtree))


def test_checkpoint_restart_bitexact(tmp_path):
    """10 steps straight == 5 steps, a checkpoint, a restart from it and 5
    more (the port's twin of the reference's test)."""
    _, tdata = _data()
    tc = ttl.TrainConfig(adamw=topt.AdamWConfig(lr=1e-3, warmup_steps=2))
    kw = dict(log_every=0, dtype=torch.float32, device="cpu")
    mgr_a = tckpt.CheckpointManager(str(tmp_path / "a"), keep=2)
    hist_a = ttl.train(TCFG, tc, tdata, steps=10, ckpt_mgr=mgr_a,
                       ckpt_every=100, **kw)
    mgr_b = tckpt.CheckpointManager(str(tmp_path / "b"), keep=2)
    ttl.train(TCFG, tc, tdata, steps=5, ckpt_mgr=mgr_b, ckpt_every=5, **kw)
    assert mgr_b.latest_step() == 5
    hist_b = ttl.train(TCFG, tc, tdata, steps=10, ckpt_mgr=mgr_b,
                       ckpt_every=100, **kw)
    assert hist_a["loss"][5:] == hist_b["loss"]


def test_checkpoint_atomic_and_retention(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(12.0).reshape(3, 4)}
    for s in (1, 2, 3):
        mgr.save(s, tree)
    os.makedirs(tmp_path / "step_4.tmp")     # a save that never finished
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    back = mgr.restore(3, tree)
    assert torch.equal(back["w"], tree["w"])
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(3, {"w": tree["w"], "v": tree["w"]})
    with pytest.raises(TypeError, match="DeviceMesh"):
        mgr.restore(3, tree, mesh=object(), specs={"w": None})


def test_bf16_checkpoints_restore_in_the_port(tmp_path):
    """bf16 leaves (the drivers' default dtype) are written as NumPy's
    bfloat16 (``ml_dtypes``), which npz keeps as 2-byte voids: the port
    restores them, from its own checkpoint and from the reference's (the
    reference's restore cannot, ROADMAP Queue 3)."""
    jp = _np(jtfm.init_params(jax.random.PRNGKey(9), JCFG, jnp.bfloat16))
    tp = params_from_jax(jp, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    tckpt.CheckpointManager(str(tmp_path / "t")).save(1, {"params": tp})
    jckpt.CheckpointManager(str(tmp_path / "j")).save(1, {"params": jp})
    for d in ("t", "j"):
        back = tckpt.CheckpointManager(str(tmp_path / d)).restore(
            1, {"params": tp})
        for got, want in zip(leaves(back), leaves({"params": tp})):
            assert got.dtype == want.dtype and torch.equal(got, want)
