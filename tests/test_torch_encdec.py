"""The encoder-decoder (whisper) and vision-prefix (InternVL2) slice
against the JAX reference on the CPU, f32: ``encode``, ``prefill`` with
``enc_frames`` or ``patches`` (last logits, the written KV pool and
cross-attention state), four chained ``decode_step`` logits and eight
greedy tokens, and ``loss_fn`` with frames or patches.  Logits within
atol 1e-5 and rtol 1e-5, loss within 1e-5, tokens identical.  InternVL2
also prefills a prompt whose vision prefix pushes it across a block
boundary (P 8 + S 125 > 128), and serves text-only traffic through both
engines' chunked and ragged paths with identical tokens and counters.
Neither engine serves whisper: the reference fails at its first prefill
(it passes no frames), the port refuses at construction.  Parameters are
made on the reference side and bridged; inputs come from a NumPy seed."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

from repro.configs import internvl2_26b as jvl  # noqa: E402
from repro.configs import whisper_small as jwh  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.config import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import internvl2_26b as tvl  # noqa: E402
from repro_torch.configs import whisper_small as twh  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from test_torch_engine import _replay, _trace  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_ATOL = 1e-5
B, MAX_LEN, GREEDY, CHAINED = 2, 384, 8, 4
CONFIGS = {"whisper": (jwh.smoke, twh.smoke),
           "internvl2": (jvl.smoke, tvl.smoke)}
#: (model, text tokens, vision prefix tokens); "internvl2-cross" puts the
#: prompt across the first block boundary only because of its prefix
PROMPTS = {"whisper": ("whisper", 40, 0),
           "whisper-cross": ("whisper", 133, 0),
           "internvl2": ("internvl2", 40, 8),
           "internvl2-cross": ("internvl2", 125, 8)}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def models():
    """Model name → (JAX config, port config, JAX params, port params),
    made on first use."""
    made = {}

    def get(name):
        if name not in made:
            jcfg, tcfg = (f() for f in CONFIGS[name])
            jp = jtfm.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
            made[name] = (jcfg, tcfg, jp, params_from_jax(
                jax.tree.map(np.asarray, jp), device="cpu"))
        return made[name]
    return get


def _inputs(cfg, seed: int, S: int, P: int) -> dict:
    """Seeded text tokens and the frames or patches the config takes."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = rng.randn(B, cfg.enc_len, cfg.d_model).astype(
            np.float32)
    if P:
        out["patches"] = rng.randn(B, P, cfg.d_model).astype(np.float32)
    return out


def _prefill_kw(inp: dict, conv) -> dict:
    kw = {}
    if "frames" in inp:
        kw["enc_frames"] = conv(inp["frames"])
    if "patches" in inp:
        kw["patches"] = conv(inp["patches"])
    return kw


def test_encode_matches_reference(models):
    jcfg, tcfg, jp, tp = models("whisper")
    frames = _inputs(jcfg, 0, 1, 0)["frames"]
    want = jtfm.encode(jp, jcfg, jnp.asarray(frames))
    got = ttfm.encode(tp, tcfg, t(frames))
    assert got.shape == (B, jcfg.enc_len, jcfg.d_model)
    close(got, want)


@pytest.mark.parametrize("page_impl", ["ref", "kernel"])
@pytest.mark.parametrize("case", sorted(PROMPTS))
def test_prefill_and_greedy_decode_match_reference(models, case, page_impl):
    """Prefill (last logits, KV pool, cross K/V, lengths = P + S), then
    greedy decode from the reference's tokens: the first four steps'
    logits within 1e-5 and all eight tokens identical."""
    name, S, P = PROMPTS[case]
    jcfg, tcfg, jp, tp = models(name)
    inp = _inputs(jcfg, 2, S, P)
    jst = jtfm.init_decode_state(jcfg, B, MAX_LEN, dtype=jnp.float32)
    tst = ttfm.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    jlg, jst = jtfm.prefill(jp, jcfg, jnp.asarray(inp["tokens"]), jst,
                            **_prefill_kw(inp, jnp.asarray))
    tlg, tst = ttfm.prefill(tp, tcfg, t(inp["tokens"]), tst,
                            **_prefill_kw(inp, t))
    close(tlg, jlg)
    np.testing.assert_array_equal(tst["lengths"], np.full(B, P + S))
    np.testing.assert_array_equal(tst["lengths"], np.asarray(jst["lengths"]))
    for k in ("kv",) + (("cross_k", "cross_v") if jcfg.enc_dec else ()):
        close(tst[k], jst[k])
    jtok = np.asarray(jlg).argmax(-1).astype(np.int32)
    ttok = tlg.argmax(-1).to(torch.int32)
    jtoks, ttoks = [jtok], [ttok.numpy()]
    for step in range(GREEDY):
        jlg, jst = jtfm.decode_step(jp, jcfg, jst, jnp.asarray(jtok))
        tlg, tst = ttfm.decode_step(tp, tcfg, tst, ttok,
                                    page_impl=page_impl)
        if step < CHAINED:
            close(tlg, jlg)
        jtok = np.asarray(jlg).argmax(-1).astype(np.int32)
        ttok = tlg.argmax(-1).to(torch.int32)
        jtoks.append(jtok)
        ttoks.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


@pytest.mark.parametrize("impl", ["chunked", "direct"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_fn_matches_reference(models, name, impl):
    """Forward-only loss with frames or patches; the P prefix positions
    carry no loss on either side."""
    jcfg, tcfg, jp, tp = models(name)
    inp = _inputs(jcfg, 3, 64, 8 if jcfg.frontend == "vision" else 0)
    labels = np.roll(inp["tokens"], -1, axis=1)
    labels[:, -5:] = -100
    batch = dict(inp, labels=labels)
    want = jtfm.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, impl=impl)
    got = ttfm.loss_fn(tp, tcfg, {k: t(v) for k, v in batch.items()},
                       impl=impl)
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=0,
                               atol=LOSS_ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_state_layout_matches_reference(name):
    jcfg, tcfg = (f() for f in CONFIGS[name])
    jspec = jtfm.cache_spec(jcfg, 3, 700, num_blocks=20, dtype=jnp.float32)
    tspec = ttfm.cache_spec(tcfg, 3, 700, num_blocks=20)
    assert {k: v[0] for k, v in jspec.items()} == \
        {k: v[0] for k, v in tspec.items()}
    assert ("cross_k" in tspec) == jcfg.enc_dec


def test_chunk_and_ragged_paths_refuse_enc_dec(models):
    """As the reference's: the fixed-shape paths take decoder-only
    models."""
    _, tcfg, _, tp = models("whisper")
    st = ttfm.init_decode_state(tcfg, 1, 256, device="cpu")
    with pytest.raises(NotImplementedError, match="enc_dec=True"):
        ttfm.prefill_chunk(tp, tcfg, torch.ones(1, 128, dtype=torch.int32),
                           st, 0)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="enc_dec=True"):
        ttfm.ragged_step(tp, tcfg, st, z, z, z, z[:1], z[:1], z[:1], z[:1])


# --------------------------------------------------------------- engines
@pytest.mark.parametrize("ragged", [False, True], ids=["chunked", "ragged"])
def test_internvl2_text_engine_trace_matches_reference(models, ragged):
    """InternVL2's text traffic (no patches: the engines prefill text
    only) through the chunked path and the ragged path."""
    jcfg, tcfg, jp, tp = models("internvl2")
    common = dict(num_blocks=64, max_batch=4, max_seq_len=512,
                  chunked_prefill=True, prefill_chunk=1,
                  ragged_kernel=ragged, admission="fcfs")
    reqs = _trace(4, 7)
    want_toks, want = _replay(JEngine(jcfg, jp, config=JConfig(
        page_impl="ref", **common)), reqs)
    got_toks, got = _replay(TEngine(tcfg, tp, config=TConfig(
        device="cpu", **common)), reqs)
    assert got_toks == want_toks
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if want[k] != v} == {}
    assert got["engine.prefill_chunk_traces"] == 1
    if ragged:
        assert got["engine.kernel.kernel_calls"] == \
            tcfg.n_layers * got["engine.kernel.ragged_steps"] > 0


def test_engines_refuse_whisper(models):
    """The reference engine passes no frames to prefill, so it fails at
    its first step; the port's engine refuses the config up front."""
    jcfg, tcfg, jp, tp = models("whisper")
    common = dict(num_blocks=16, max_batch=2, max_seq_len=256)
    jeng = JEngine(jcfg, jp, config=JConfig(page_impl="ref", **common))
    jeng.submit(np.arange(1, 20), max_new_tokens=2)
    with pytest.raises(TypeError):
        jeng.step()
    with pytest.raises(NotImplementedError, match="engine.py:206"):
        TEngine(tcfg, tp, config=TConfig(device="cpu", **common))
