"""Engine traces through ``repro.serving.engine.Engine`` and
``repro_torch.serving.engine.Engine`` on the CPU: the same seeded
requests give identical greedy tokens, and every deterministic key of
``metrics.snapshot()`` is equal (fences, recycled hits, refreshed bytes,
admission, prefix sharing, chunk and kernel counters).  Only wall time,
tokens/s, measured fence seconds and the step-latency histogram are
excluded."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JCfg  # noqa: E402
from repro.serving.config import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models.config import ModelConfig as TCfg  # noqa: E402
from repro_torch.serving.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402

_CFG_KW = dict(name="trace", n_layers=1, d_model=32, n_heads=2,
               n_kv_heads=1, d_ff=64, vocab=64, head_dim=16)
_NONDETERMINISTIC = ("wall_s", "tokens_per_s", "step_latency", "measured_s")


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCfg(**_CFG_KW),
                          jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _trace(seed: int, n: int, shared_prefix: int = 0):
    """Seeded (prompt, stream, group, max_new) requests of mixed,
    non-block-aligned lengths; with ``shared_prefix`` every prompt starts
    with the same tokens and one prompt is exactly that prefix."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, _CFG_KW["vocab"], size=shared_prefix)
    reqs = []
    for i in range(n):
        tail = rng.randint(1, _CFG_KW["vocab"], size=rng.randint(4, 200))
        prompt = np.concatenate([prefix, tail]) if shared_prefix else tail
        if shared_prefix and i == n - 1:
            prompt = prefix.copy()
        reqs.append((prompt, f"s{i % 3}", i % 3 + 1, 4 + i % 3))
    return reqs


def _replay(engine, reqs):
    for prompt, stream, gid, mnt in reqs:
        engine.submit(prompt, max_new_tokens=mnt, stream=stream,
                      group_id=gid)
    while not engine.sched.idle and engine.steps < 10_000:
        engine.step()
    toks = [list(map(int, r.generated))
            for r in sorted(engine.sched.done, key=lambda r: r.rid)]
    snap = {k: v for k, v in engine.metrics.snapshot().items()
            if not any(s in k for s in _NONDETERMINISTIC)}
    return toks, snap


CASES = {
    "fpr": dict(kw=dict(fpr_enabled=True), trace=(1, 12)),
    "baseline": dict(kw=dict(fpr_enabled=False), trace=(1, 12)),
    "scoped-w4": dict(kw=dict(num_workers=4, scoped_fences=True,
                              admission="fcfs"), trace=(2, 8)),
    "chunked": dict(kw=dict(chunked_prefill=True, prefill_chunk=1,
                            admission="fcfs"), trace=(3, 7)),
    "ragged": dict(kw=dict(chunked_prefill=True, prefill_chunk=1,
                           ragged_kernel=True, admission="fcfs"),
                   trace=(4, 7)),
    "prefix": dict(kw=dict(prefix_sharing=True, admission="fcfs"),
                   trace=(5, 6, 256)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_trace_matches_reference(params, name):
    jp, tp = params
    case = CASES[name]
    common = dict(num_blocks=64, max_batch=4, max_seq_len=512, **case["kw"])
    reqs = _trace(*case["trace"])
    want_toks, want = _replay(
        JEngine(JCfg(**_CFG_KW), jp, config=JConfig(page_impl="ref",
                                                    **common)), reqs)
    got_toks, got = _replay(
        TEngine(TCfg(**_CFG_KW), tp, config=TConfig(device="cpu",
                                                    **common)), reqs)
    assert got_toks == want_toks
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if want[k] != v} == {}
    if name == "prefix":
        assert got["fpr.prefix.hit_blocks"] > 0
    if name == "ragged":
        assert got["engine.prefill_chunk_traces"] == 1
        assert got["engine.kernel.kernel_calls"] == \
            got["engine.kernel.ragged_steps"]
    if name == "fpr":
        assert got["fpr.recycled_hits"] > 0 and got["fence.skipped_at_free"]


def test_engine_config_defaults_and_checks():
    cfg = TConfig()
    assert (cfg.device, cfg.dtype, cfg.page_impl) == ("cuda", torch.float32,
                                                      "kernel")
    with pytest.raises(ValueError):
        TConfig(page_impl="pallas")
    with pytest.raises(ValueError):
        TConfig(ragged_kernel=True, chunked_prefill=False)
