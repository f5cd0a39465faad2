"""Gradients of the port against ``jax.grad`` of the reference on the CPU,
f32: ``chunked_attention``'s autograd Function against the reference's
custom VJP (dq, dk, dv within 1e-5 of each tensor's largest entry), and
``loss_fn``'s value and every parameter's gradient against
``jax.value_and_grad`` (1e-5 relative to the leaf's largest entry) on the
attention-only decoder smoke configs, with and without remat.  The other
smoke configs are in ``test_torch_train_grads_hybrid.py`` (Jamba,
RWKV-6) and ``test_torch_train_grads_families.py`` (MLA, MoE with routing
groups, whisper, InternVL2): the reference's gradients take seconds to
tens of seconds each on the CPU, so three files spread them over the
test workers.  Parameters are made on the reference side and bridged;
inputs come from a NumPy seed."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.bridge import (leaves, params_from_jax,  # noqa: E402
                                params_to_jax, tree_map)
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

GRAD_RTOL = 1e-5
B, S = 2, 40
#: the smoke configs of each gradient file; together all ten
ATTN_ONLY = ("deepseek-7b", "granite-3-8b", "h2o-danube-3-4b",
             "qwen2.5-14b")
HYBRID = ("jamba-v0.1-52b", "rwkv6-7b")
FAMILIES = ("deepseek-moe-16b", "deepseek-v2-236b", "internvl2-26b",
            "whisper-small")


def _close_rel(got, want, rtol, what=""):
    """Max |got - want| within ``rtol`` of max |want|; a leaf whose
    largest entry is below 1e-5 (a near-zero gradient, a sum of
    cancelling terms) is held at ``rtol`` × 1e-5 absolute."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    scale = np.abs(want).max(initial=0.0)
    assert err <= rtol * max(scale, 1e-5), (what, err, scale)


# ------------------------------------------------------ chunked attention ----
#: (Sq, Sk, H, KV, causal, window, q_offset, chunk)
ATTN_CASES = {
    "gqa-causal": (48, 48, 4, 2, True, None, 0, 16),
    "window": (48, 48, 4, 1, True, 9, 0, 16),
    "q-offset": (24, 56, 6, 2, True, None, 32, 16),
    "sk-not-chunk-multiple": (37, 37, 2, 2, True, None, 0, 16),
    "non-causal-cross": (20, 45, 4, 4, False, None, 0, 16),
    "window-offset": (16, 40, 4, 2, True, 7, 24, 8),
}


def _attn_inputs(Sq, Sk, H, KV, seed=0, hd=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, Sq, H, hd).astype(np.float32),
            rng.randn(2, Sk, KV, hd).astype(np.float32),
            rng.randn(2, Sk, KV, hd).astype(np.float32),
            rng.randn(2, Sq, H, hd).astype(np.float32))


def _attn_grads(q, k, v, dout, **kw):
    """(out, dq, dk, dv) from both packages for cotangent ``dout``."""
    def ref(q, k, v, d):
        out, vjp = jax.vjp(
            lambda q, k, v: jattn.chunked_attention(q, k, v, **kw), q, k, v)
        return (out, *vjp(d))
    want = jax.jit(ref)(*(jnp.asarray(a) for a in (q, k, v, dout)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = tattn.chunked_attention(tq, tk, tv, **kw)
    tg = torch.autograd.grad(tout, (tq, tk, tv), torch.tensor(dout))
    return want, (tout.detach(), *tg)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_grads_match_reference_vjp(case):
    Sq, Sk, H, KV, causal, window, q_offset, chunk = ATTN_CASES[case]
    q, k, v, dout = _attn_inputs(Sq, Sk, H, KV)
    want, got = _attn_grads(q, k, v, dout, causal=causal, window=window,
                            q_offset=q_offset, chunk=chunk)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close_rel(g.numpy(), w, GRAD_RTOL, name)


def test_chunked_attention_query_blocks_match_reference(monkeypatch):
    """Q_BLOCK patched small in both packages: the forward and backward
    run four query blocks, dk and dv summed across them in f32."""
    monkeypatch.setattr(jattn, "Q_BLOCK", 16)
    monkeypatch.setattr(tattn, "Q_BLOCK", 16)
    q, k, v, dout = _attn_inputs(64, 64, 4, 2, seed=1)
    want, got = _attn_grads(q, k, v, dout, causal=True, window=20,
                            chunk=16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close_rel(g.numpy(), w, GRAD_RTOL, name)


def test_chunked_attention_matches_direct_and_inference_form():
    """The Function's output and gradients equal autograd through the
    O(S²) oracle, and its forward equals ``chunked_attention_fwd``."""
    q, k, v, dout = _attn_inputs(33, 33, 4, 2, seed=2)
    outs, grads = [], []
    for fn in (tattn.chunked_attention, tattn.direct_attention):
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = fn(tq, tk, tv, causal=True, window=12)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, (tq, tk, tv),
                                         torch.tensor(dout)))
    _close_rel(outs[0], outs[1], GRAD_RTOL, "out")
    for g, w in zip(*grads):
        _close_rel(g, w, GRAD_RTOL)
    fwd = tattn.chunked_attention_fwd(*(torch.tensor(a) for a in (q, k, v)),
                                      causal=True, window=12)
    assert torch.equal(fwd, outs[0])


def test_cross_entropy_value_and_grad_match_reference():
    """``layers.cross_entropy``: the mean NLL over labels that are not
    -100, and its gradient in the logits."""
    from repro.models.layers import cross_entropy as jce
    from repro_torch.models.layers import cross_entropy as tce
    rng = np.random.RandomState(3)
    logits = (rng.randn(3, 7, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, (3, 7)).astype(np.int32)
    labels[0, :2] = labels[2, 6] = -100
    want, jg = jax.value_and_grad(jce)(jnp.asarray(logits),
                                       jnp.asarray(labels))
    tl = torch.tensor(logits, requires_grad=True)
    got = tce(tl, torch.from_numpy(labels))
    _close_rel(got.item(), float(want), 1e-6)
    _close_rel(torch.autograd.grad(got, tl)[0].numpy(), jg, GRAD_RTOL)


# ---------------------------------------------------------------- loss_fn ----
def make_batch(cfg, seed=0) -> dict:
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -3:] = -100
    labels[0, 5] = -100
    batch = {"tokens": tokens, "labels": labels}
    if cfg.enc_dec:
        batch["frames"] = rng.randn(B, cfg.enc_len, cfg.d_model).astype(
            np.float32)
    if cfg.frontend == "vision":
        batch["patches"] = rng.randn(B, 6, cfg.d_model).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def smoke():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, tcfg = jsmoke(arch), tsmoke(arch)
            jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
            cache[arch] = (jcfg, tcfg, jax.tree.map(np.asarray, jp))
        return cache[arch]
    return get


def port_value_and_grad(tree, tcfg, batch, **kw):
    params = params_from_jax(tree, device="cpu")
    live = tree_map(lambda t: t.requires_grad_(), params)
    loss = ttfm.loss_fn(live, tcfg,
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        **kw)
    grads = torch.autograd.grad(loss, leaves(live), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return loss.item(), params_to_jax(tree_map(lambda _: next(it), live))


def _ref_value_and_grad(tree, jcfg, batch, **kw):
    """Jitted: eager, the reference's scans and layers dispatch op by op
    and take several times as long."""
    f = jax.jit(jax.value_and_grad(functools.partial(jtfm.loss_fn, **kw)),
                static_argnums=1)
    loss, grads = f(jax.tree.map(jnp.asarray, tree), jcfg,
                    {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), grads


def check_grads(got, want, rtol=lambda name: GRAD_RTOL):
    """Every leaf of ``got`` (the port's, bridged) against ``want`` (the
    reference's), at ``rtol(leaf name)``."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        name = jax.tree_util.keystr(path)
        _close_rel(g, w, rtol(name), name)


def check_loss_and_grads(smoke, arch, rtol=lambda name: GRAD_RTOL, **kw):
    jcfg, tcfg, tree = smoke(arch)
    batch = make_batch(jcfg)
    want_loss, want = _ref_value_and_grad(tree, jcfg, batch, **kw)
    got_loss, got = port_value_and_grad(tree, tcfg, batch, **kw)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    check_grads(got, want, rtol)
    return got_loss


def check_remat(smoke, arch):
    """remat=True against remat=False: loss and every gradient within
    1e-6 (the recompute runs the same operations)."""
    _, tcfg, tree = smoke(arch)
    batch = make_batch(tcfg, seed=1)
    runs = [port_value_and_grad(tree, tcfg, batch, remat=r)
            for r in (True, False)]
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6)
    jax.tree.map(lambda a, b: _close_rel(a, b, 1e-6), runs[0][1],
                 runs[1][1])


def test_the_grad_files_cover_every_smoke_config():
    assert sorted(ATTN_ONLY + HYBRID + FAMILIES) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch", ATTN_ONLY)
def test_loss_fn_value_and_grads_match_reference(smoke, arch):
    check_loss_and_grads(smoke, arch)


def test_remat_changes_neither_loss_nor_grads(smoke):
    check_remat(smoke, "granite-3-8b")
