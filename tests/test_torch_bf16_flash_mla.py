"""bf16 inputs to the port's flash attention and absorbed-MLA decode,
against the JAX reference on the CPU.

The reference's Pallas kernels read any float, compute in f32 and write
``q.dtype`` (flash) or f32 (MLA); the port's wrappers do the same (their
CPU path is the plain version).  Inputs are drawn in f32 from a NumPy
seed and rounded to bf16 (to nearest even) the same way on both sides.

* Flash: every ``FLASH`` case of ``_torch_cases`` in the three (q, k/v)
  pairs other than (f32, f32), ``ops.flash_attention`` against the
  reference's op in interpret mode at the same dtypes: the output has
  q's dtype and agrees within ``atol=1e-5, rtol=8e-3`` on the upcast
  values, one bf16 ulp (2**-7 of the value), the most that one rounding
  of the same f32 result summed in another order can move a bf16 output.
* MLA: every ``MLA`` and ``MLA_SPLITS`` case in the three (queries,
  pools) pairs, against ``mla_paged_ctx_fwd(interpret=True)``: the
  context is f32 on both sides, at ``test_torch_mla.py``'s 2e-5.
* ``attn_layer(impl="kernel")`` with bf16 params (Jamba's and danube's
  smoke configs) against the reference's ``impl="pallas_interpret"``:
  the projections round to bf16 on each side, so within 3e-2 ·
  max(1, max|want|), the reference's own bf16 flash tolerance
  (``tests/test_kernels.py:49``).
* DeepSeek-V2 smoke with bf16 params over a bf16 latent pool: ``prefill``
  and 4 teacher-forced ``decode_step(page_impl="kernel")`` against the
  reference's ``page_impl="pallas_interpret"``: tokens equal but at a
  bf16 near-tie of the reference's logits (top-2 margin at most 3e-2 ·
  max(1, |top logit|), ``chip_smoke.check_picks``' rule), layer 0's
  pools within one bf16 ulp (see the test for the deeper layers).
* The DeepSeek-V2 smoke served by both engines from a bf16 pool with f32
  params (f32 queries): tokens and every deterministic counter equal.
  With bf16 params the two frameworks' bf16 arithmetic outside the MLA
  decode flips an MoE routing near-tie, and free-running engines then
  serve other tokens.  The engine counts DMA bytes only on its ragged
  path, which MLA does not take, so the pool's bytes are checked
  instead: 2 an element, half the f32 engine's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.configs import deepseek_v2_236b as jdsv2  # noqa: E402
from repro.configs import h2o_danube_3_4b as jdanube  # noqa: E402
from repro.configs import jamba_v0_1_52b as jjamba  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.kernels.mla_attention import mla_attention as jmk  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.config import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.bridge import (from_numpy, params_from_jax,  # noqa: E402
                                state_from_jax)
from repro_torch.configs import deepseek_v2_236b as tdsv2  # noqa: E402
from repro_torch.configs import h2o_danube_3_4b as tdanube  # noqa: E402
from repro_torch.configs import jamba_v0_1_52b as tjamba  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.kernels.mla_attention import mla_attention as tmk  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from _torch_cases import (BF16_PAIRS, FLASH, MLA, MLA_SPLITS,  # noqa: E402
                          flash_case, mla_case, mla_split_case, rand,
                          shard_stack)
from test_torch_bf16 import TOL, both  # noqa: E402
from test_torch_engine import CASES, _replay, _trace  # noqa: E402

#: an f32 context summed in another order (test_torch_mla.py)
F32_TOL = dict(atol=2e-5, rtol=2e-5)
#: the reference's bf16 flash-kernel tolerance, scaled by max(1, max|want|)
LAYER_TOL = 3e-2
BF16_TIE = 3e-2


def upcast(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize("q_dtype,kv_dtype", BF16_PAIRS)
@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_in_bf16_matches_pallas(case, q_dtype, kv_dtype):
    c = flash_case(40, **case)
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_offset"])
    jq, tq = both(c["q"], q_dtype)
    (jk, tk), (jv, tv) = both(c["k"], kv_dtype), both(c["v"], kv_dtype)
    want = jfa.flash_attention(jq, jk, jv, interpret=True, **kw)
    got = tfa.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == getattr(torch, q_dtype)
    assert want.dtype == getattr(jnp, q_dtype)
    np.testing.assert_allclose(upcast(got), upcast(want), **TOL)


# -------------------------------------------------------------------- MLA
MLA_CASES = ([("mla", c) for c in MLA]
             + [("split", c) for c in MLA_SPLITS])


@pytest.mark.parametrize("q_dtype,pool_dtype", BF16_PAIRS)
@pytest.mark.parametrize("kind,case", MLA_CASES, ids=str)
def test_mla_in_bf16_matches_pallas(kind, case, q_dtype, pool_dtype):
    c = (mla_split_case(41, **case) if kind == "split"
         else mla_case(41, **case))
    (jql, tql), (jqr, tqr) = (both(c[k], q_dtype)
                              for k in ("q_lat", "q_rope"))
    (jc, tc), (jkr, tkr) = (both(c[k], pool_dtype) for k in ("c", "kr"))
    want = jmk.mla_paged_ctx_fwd(jql, jqr, jc, jkr, jnp.asarray(c["stack"]),
                                 jnp.asarray(c["lengths"]), scale=c["scale"],
                                 interpret=True)
    got = tmk.mla_paged_ctx_fwd(tql, tqr, tc, tkr,
                                torch.from_numpy(c["stack"]),
                                torch.from_numpy(c["lengths"]),
                                scale=c["scale"])
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    seen_nothing = (c["mono"] < 0).all(1) | (c["lengths"] == 0)
    assert not got[torch.from_numpy(seen_nothing)].any()


# -------------------------------------------------------------- attn_layer
@pytest.mark.parametrize("model", ["jamba", "danube"])
def test_attn_layer_in_bf16_matches_pallas(model):
    """bf16 params and activations: Jamba's attention layer (no rope) and
    danube's (rope, window 32); the output has the params' dtype."""
    jcfg, tcfg = {"jamba": (jjamba.smoke(), tjamba.smoke()),
                  "danube": (jdanube.smoke(), tdanube.smoke())}[model]
    jp = jattn.init_attn(jax.random.PRNGKey(5), jcfg, jnp.bfloat16)
    tp = {k: from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    rng = np.random.RandomState(42)
    B, S = 2, 90
    jx, tx = both(rand(rng, B, S, tcfg.d_model), "bfloat16")
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = jattn.attn_layer(jp, jx, jnp.asarray(pos), jcfg,
                            impl="pallas_interpret")
    got = tattn.attn_layer(tp, tx, torch.from_numpy(pos.copy()), tcfg,
                           impl="kernel")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    w = upcast(want)
    np.testing.assert_allclose(upcast(got), w, rtol=0,
                               atol=LAYER_TOL * max(1.0, np.abs(w).max()))


# ------------------------------------------------------------ DeepSeek-V2
SLOTS, M, N, BS = 4, 3, 16, 128


def near_tie(logits: np.ndarray) -> np.ndarray:
    """Rows whose top-2 logit margin is a bf16 near-tie."""
    top = np.sort(logits, axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0] <= BF16_TIE * np.maximum(1.0,
                                                          np.abs(top[:, 1]))


@pytest.mark.parametrize("W", [1, 2])
def test_deepseek_v2_bf16_decode_matches_pallas(W):
    """bf16 params over a bf16 latent pool: prefill every slot, then 4
    decode steps through the MLA kernel's wrapper (the plain version on
    the CPU) against the reference's Pallas kernel in interpret mode, both
    fed the reference's greedy tokens (teacher forcing): the port's own
    pick equals the reference's but at a bf16 near-tie; layer 0's latent
    and rope pools, every row prefill and decode wrote, within one bf16
    ulp.  Deeper layers'
    latents follow bf16 arithmetic outside the MLA decode (layer 0's
    attention output, the FFN, and MoE routing, which a near-tie of the
    router's f32 logits flips), which the two frameworks round apart, so
    they are not compared element by element."""
    jcfg, tcfg = jdsv2.smoke(), tdsv2.smoke()
    jp = jtfm.init_params(jax.random.PRNGKey(8), jcfg, jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert ttfm.layer_params(tp, tcfg, 0)["mix"]["wkv_b"].dtype == \
        torch.bfloat16
    rng = np.random.RandomState(30 + W)
    prompt = rng.randint(1, jcfg.vocab, (SLOTS, 150)).astype(np.int32)
    mono = np.arange(SLOTS * M, dtype=np.int32).reshape(SLOTS, M)
    spec = jtfm.cache_spec(jcfg, SLOTS, M * BS, N, jnp.bfloat16)
    jst = {k: jnp.zeros(spec[k][0], jnp.bfloat16)
           for k in ("mla_c", "mla_rope")}
    jst.update(tables=jnp.asarray(shard_stack(mono, W)),
               lengths=jnp.zeros(SLOTS, jnp.int32))
    tst = state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    assert tst["mla_c"].dtype == torch.bfloat16
    jlg, jst = jtfm.prefill(jp, jcfg, jnp.asarray(prompt), jst)
    tlg, tst = ttfm.prefill(tp, tcfg, torch.from_numpy(prompt), tst)
    differ = 0
    for step in range(5):
        want = upcast(jlg)
        jt = want.argmax(-1).astype(np.int32)
        picks = tlg.float().argmax(-1).numpy()
        assert not ((picks != jt) & ~near_tie(want)).any(), step
        differ += int((picks != jt).sum())
        for k in ("mla_c", "mla_rope"):
            assert tst[k].dtype == torch.bfloat16
            np.testing.assert_allclose(upcast(tst[k][0]), upcast(jst[k][0]),
                                       **TOL)
        if step == 4:
            break
        tt = torch.from_numpy(jt)
        jlg, jst = jtfm.decode_step(jp, jcfg, jst, jnp.asarray(jt),
                                    page_impl="pallas_interpret")
        tlg, tst = ttfm.decode_step(tp, tcfg, tst, tt, page_impl="kernel")
    assert differ <= SLOTS
    np.testing.assert_array_equal(tst["lengths"], np.asarray(jst["lengths"]))


def test_deepseek_v2_engine_from_a_bf16_pool_matches_reference():
    """test_torch_engine.py's ``deepseek-v2`` trace (fpr on) served from a
    bf16 latent pool by both engines (``page_impl="ref"`` on the
    reference's side; the port's MLA decode through the kernel wrapper),
    f32 params: the model path's (f32 queries, bf16 pool) pair."""
    jcfg, tcfg = jdsv2.smoke(), tdsv2.smoke()
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    case = CASES["deepseek-v2"]
    common = {"num_blocks": 64, "max_batch": 4, "max_seq_len": 512,
              **case["kw"]}
    reqs = _trace(*case["trace"])
    want_toks, want = _replay(JEngine(jcfg, jp, config=JConfig(
        page_impl="ref", dtype=jnp.bfloat16, **common)), reqs)
    eng = TEngine(tcfg, tp, config=TConfig(device="cpu",
                                           dtype=torch.bfloat16, **common))
    got_toks, got = _replay(eng, reqs)
    assert got_toks == want_toks
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if want[k] != v} == {}
    assert got["fpr.recycled_hits"] > 0
    f32 = TEngine(tcfg, tp, config=TConfig(device="cpu",
                                           dtype=torch.float32, **common))
    for k in ("mla_c", "mla_rope"):
        pool = eng.cache.state[k]
        assert pool.dtype == torch.bfloat16 and pool.element_size() == 2
        assert 2 * pool.nbytes == f32.cache.state[k].nbytes
