"""bf16 pools and queries in the port's paged attention, against the JAX
reference on the CPU.

The reference's Pallas kernels take any float pool and query, compute in
f32 and write ``q.dtype``; the port's wrappers do the same (their CPU
path is the plain version).  Kernel parity: every ``PAGED`` and
``RAGGED`` case of ``_torch_cases`` in the three (q, pool) pairs other
than (f32, f32), through ``ops.paged_attention`` (depths 1/2/4),
``ops.paged_attention_split`` and ``ops.ragged_paged_attention`` (real
rows), against the reference's ``ops`` in interpret mode at the same
dtypes.  Inputs are drawn in f32 from a NumPy seed and rounded to bf16
(to nearest even) the same way on both sides.  Outputs have q's dtype and
agree within ``atol=1e-5, rtol=8e-3`` on the upcast values: one bf16 ulp
(2**-7 of the value), the most that one rounding of the same f32 result
computed in another summation order can move a bf16 output.

Engine parity: the ``fpr``, ``chunked`` and ``ragged`` traces of
``test_torch_engine.py`` served from a bf16 pool (``EngineConfig(dtype=
bfloat16)``) with f32 params (the queries stay f32) and with bf16 params
(all bf16), against the reference engine with ``page_impl="ref"``:
tokens and every deterministic counter equal, ``engine.kernel.dma_bytes``
(2 bytes an element) included."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JCfg  # noqa: E402
from repro.serving.config import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.models.config import ModelConfig as TCfg  # noqa: E402
from repro_torch.serving.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from _torch_cases import (BF16_PAIRS, PAGED, RAGGED, paged_case,  # noqa: E402
                          ragged_case)
from test_torch_engine import CASES, _CFG_KW, _replay, _trace  # noqa: E402

#: one bf16 ulp (2**-7 relative), and an absolute floor for outputs near 0
TOL = dict(atol=1e-5, rtol=8e-3)


def both(a, dtype: str):
    """The f32 NumPy array ``a`` rounded to ``dtype`` for each side: (jax
    array, torch tensor)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.array(a, copy=True)).to(getattr(torch,
                                                                dtype)))


def close(got: torch.Tensor, want, dtype: str):
    assert got.dtype == getattr(torch, dtype)
    assert want.dtype == getattr(jnp, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **TOL)


@pytest.mark.parametrize("q_dtype,pool_dtype", BF16_PAIRS)
@pytest.mark.parametrize("case", PAGED, ids=str)
def test_decode_in_bf16_matches_pallas(case, q_dtype, pool_dtype):
    c = paged_case(30, **case)
    w = c["window"]
    jq, tq = both(c["q"], q_dtype)
    jkv, tkv = both(c["kv"], pool_dtype)
    stack = jnp.asarray(c["stack"])
    ts, tl = torch.from_numpy(c["stack"]), torch.from_numpy(c["lengths"])
    want = jops.paged_attention(jq, jkv, stack, c["lengths"], window=w,
                                buffer_depth=2, interpret=True)
    for depth in (1, 2, 4):
        close(tops.paged_attention(tq, tkv, ts, tl, window=w,
                                   buffer_depth=depth), want, q_dtype)
    kp = np.ascontiguousarray(c["kv"][:, :, 0::2])
    vp = np.ascontiguousarray(c["kv"][:, :, 1::2])
    (jkp, tkp), (jvp, tvp) = both(kp, pool_dtype), both(vp, pool_dtype)
    close(tops.paged_attention_split(tq, tkp, tvp, ts, tl, window=w),
          jops.paged_attention_split(jq, jkp, jvp, stack, c["lengths"],
                                     window=w, interpret=True), q_dtype)


@pytest.mark.parametrize("q_dtype,pool_dtype", BF16_PAIRS)
@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_ragged_in_bf16_matches_pallas(case, q_dtype, pool_dtype):
    """Real rows only: padding rows are finite garbage in the kernels."""
    c = ragged_case(31, **case)
    d, w = c["d"], c["window"]
    jq, tq = both(c["q"], q_dtype)
    jkv, tkv = both(c["kv"], pool_dtype)
    real = d["token_row"] >= 0
    got = tops.ragged_paged_attention(
        tq, tkv, torch.from_numpy(c["stack"]),
        *(torch.from_numpy(d[k]) for k in ("tile_row", "tile_pos",
                                           "kv_lens")), window=w)
    want = jops.ragged_paged_attention(
        jq, jkv, jnp.asarray(c["stack"]), d["tile_row"], d["tile_pos"],
        d["kv_lens"], window=w, interpret=True)
    close(got[torch.from_numpy(real)], want[real], q_dtype)


# ------------------------------------------------------------ engine traces
#: test_torch_engine.py's traces of the paths the bf16 kernels serve
ENGINE_CASES = {k: CASES[k] for k in ("fpr", "chunked", "ragged")}


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, {param dtype: (JAX params, port params)})
    of the tiny attention model; bf16 params are the f32 ones rounded on
    each side."""
    jcfg, tcfg = JCfg(**_CFG_KW), TCfg(**_CFG_KW)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    host = jax.tree.map(np.asarray, jp)
    params = {
        "float32": (jp, params_from_jax(host, device="cpu")),
        "bfloat16": (jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp),
                     params_from_jax(host, device="cpu",
                                     dtype=torch.bfloat16))}
    return jcfg, tcfg, params


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_bf16_pool_engine_trace_matches_reference(tiny, name, param_dtype):
    jcfg, tcfg, params = tiny
    jp, tp = params[param_dtype]
    case = ENGINE_CASES[name]
    common = {"num_blocks": 64, "max_batch": 4, "max_seq_len": 512,
              **case["kw"]}
    reqs = _trace(*case["trace"])
    want_toks, want = _replay(JEngine(jcfg, jp, config=JConfig(
        page_impl="ref", dtype=jnp.bfloat16, **common)), reqs)
    eng = TEngine(tcfg, tp, config=TConfig(device="cpu",
                                           dtype=torch.bfloat16, **common))
    got_toks, got = _replay(eng, reqs)
    assert eng.cache.state["kv"].dtype == torch.bfloat16
    assert got_toks == want_toks
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if want[k] != v} == {}
    if name == "fpr":
        assert got["fpr.recycled_hits"] > 0
    if name == "ragged":
        assert got["engine.prefill_chunk_traces"] == 1
        assert got["engine.kernel.kernel_calls"] == \
            tcfg.n_layers * got["engine.kernel.ragged_steps"]
        # the same trace over an f32 pool moves twice the bytes
        _, f32 = _replay(TEngine(tcfg, tp, config=TConfig(
            device="cpu", dtype=torch.float32, **common)), reqs)
        assert f32["engine.kernel.ragged_steps"] == \
            got["engine.kernel.ragged_steps"]
        assert f32["engine.kernel.dma_bytes"] == \
            2 * got["engine.kernel.dma_bytes"] > 0
