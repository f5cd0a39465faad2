"""The hybrid slice as a whole against the JAX reference on the CPU: the
Jamba (Mamba + attention + MoE) and RWKV-6 smoke configs through
``prefill`` (both scans against the reference's Pallas kernels in
interpret mode: logits and every cache and state within 1e-4), greedy
``decode_step`` (identical tokens), ``loss_fn`` (1e-5 absolute) and the
bridge's f32 leaves under a dtype cast.  Parameters are made on the
reference side and bridged; tokens come from a NumPy seed."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.configs import jamba_v0_1_52b as jjamba  # noqa: E402
from repro.configs import rwkv6_7b as jrwkv  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.bridge import F32_LEAVES, params_from_jax, state_from_jax  # noqa: E402
from repro_torch.configs import jamba_v0_1_52b as tjamba  # noqa: E402
from repro_torch.configs import rwkv6_7b as trwkv  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

STATE_TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = {"jamba": (jjamba.smoke, tjamba.smoke),
           "rwkv6": (jrwkv.smoke, trwkv.smoke)}
B, S, MAX_LEN = 2, 150, 384


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or STATE_TOL))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jmake, tmake = CONFIGS[request.param]
    jcfg, tcfg = jmake(), tmake()
    jp = jtfm.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def reference_run(model):
    """The reference's prefill (scans in interpret mode) and 8 greedy
    decode steps: tokens, logits and every state after each call."""
    _, jcfg, _, jp, _ = model
    rng = np.random.RandomState(2)
    prompt = rng.randint(1, jcfg.vocab, (B, S)).astype(np.int32)
    st0 = jax.tree.map(np.asarray, jtfm.init_decode_state(
        jcfg, B, MAX_LEN, dtype=jnp.float32))
    lg, st = jtfm.prefill(jp, jcfg, jnp.asarray(prompt),
                          {k: jnp.asarray(v) for k, v in st0.items()},
                          impl="pallas_interpret")
    steps = [(np.asarray(lg), jax.tree.map(np.asarray, st))]
    tok = np.asarray(lg).argmax(-1).astype(np.int32)
    toks = [tok]
    for _ in range(8):
        lg, st = jtfm.decode_step(jp, jcfg, st, jnp.asarray(tok))
        tok = np.asarray(lg).argmax(-1).astype(np.int32)
        toks.append(tok)
        steps.append((np.asarray(lg), None))
    return prompt, st0, steps, np.stack(toks), jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_prefill_and_greedy_decode_match_reference(model, reference_run,
                                                   impl):
    name, _, tcfg, _, tp = model
    prompt, st0, steps, want_toks, want_final = reference_run
    tst = state_from_jax(st0, device="cpu")
    lg, tst = ttfm.prefill(tp, tcfg, t(prompt), tst, impl=impl)
    want_lg, want_st = steps[0]
    close(lg, want_lg, **LOGIT_TOL)
    keys = {"jamba": ("kv", "conv", "ssm"), "rwkv6": ("rwkv_x", "rwkv_s")}
    assert set(keys[name]) <= set(tst)
    for k in keys[name]:
        close(tst[k], want_st[k])
    tok = lg.argmax(-1).to(torch.int32)
    toks = [tok.numpy()]
    for i in range(8):
        lg, tst = ttfm.decode_step(tp, tcfg, tst, tok, page_impl="kernel")
        close(lg, steps[i + 1][0], **LOGIT_TOL)
        tok = lg.argmax(-1).to(torch.int32)
        toks.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(toks), want_toks)
    for k in keys[name]:
        close(tst[k], want_final[k])
    np.testing.assert_array_equal(tst["lengths"], want_final["lengths"])


@pytest.mark.parametrize("impl", ["chunked", "sequential", "kernel"])
def test_loss_fn_matches_reference(model, impl):
    """Forward-only loss; the reference's twin of ``"kernel"`` is its
    Pallas path in interpret mode (attention then runs
    ``direct_attention`` on both sides, as the reference does)."""
    _, jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(3)
    tokens = rng.randint(1, jcfg.vocab, (B, 96)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -5:] = -100
    jimpl = "pallas_interpret" if impl == "kernel" else impl
    want = jtfm.loss_fn(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels)},
                        impl=jimpl)
    got = ttfm.loss_fn(tp, tcfg, {"tokens": t(tokens), "labels": t(labels)},
                       impl=impl)
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)


def test_decode_state_layout_matches_reference(model):
    _, jcfg, tcfg, _, _ = model
    jspec = jtfm.cache_spec(jcfg, 3, 700, num_blocks=20, dtype=jnp.float32)
    tspec = ttfm.cache_spec(tcfg, 3, 700, num_blocks=20)
    assert {k: v[0] for k, v in jspec.items()} == \
        {k: v[0] for k, v in tspec.items()}
    assert {k: np.dtype(v[1]).name for k, v in jspec.items()} == \
        {k: str(v[1]).removeprefix("torch.") for k, v in tspec.items()}


def test_bridge_keeps_f32_leaves_under_a_dtype_cast(model):
    name, jcfg, tcfg, jp, _ = model
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                         dtype=torch.bfloat16)
    seen = set()

    def walk(tree, key=None):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, key)
        else:
            want = torch.float32 if key in F32_LEAVES else torch.bfloat16
            assert tree.dtype == want, (key, tree.dtype)
            seen.add(key)
    walk(tp)
    assert {"jamba": {"A_log", "D", "router"},
            "rwkv6": {"u", "ln_x"}}[name] <= seen


def test_prefill_refuses_an_unknown_impl(model):
    _, _, tcfg, _, tp = model
    st = ttfm.init_decode_state(tcfg, 1, 128, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        ttfm.prefill(tp, tcfg, torch.ones(1, 8, dtype=torch.int32), st,
                     impl="pallas")
