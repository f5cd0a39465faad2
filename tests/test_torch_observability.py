"""The copied observability and simulation modules behave as the
reference's on live data: a ``TraceCollector`` on each package's engine,
driven by the same seeded trace, records the same Chrome-trace events
(name, track, category and args; times differ); ``export.render_registry``
of both engines' registries gives the same metric families and ``# TYPE``
lines; and ``serving.sim`` returns identical results for one seeded
configuration of each simulator."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import export as jexport  # noqa: E402
from repro.core.tracing import TraceCollector as JTrace  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JCfg  # noqa: E402
from repro.serving import sim as jsim  # noqa: E402
from repro.serving.config import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core import export as texport  # noqa: E402
from repro_torch.core.tracing import TraceCollector as TTrace  # noqa: E402
from repro_torch.models.config import ModelConfig as TCfg  # noqa: E402
from repro_torch.serving import sim as tsim  # noqa: E402
from repro_torch.serving.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402

_TINY = dict(name="tiny", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
             d_ff=64, vocab=64, head_dim=16)
#: a small pool shared by two workers under chunked prefill: admissions,
#: prefill chunks, fences and shard refreshes all reach the bus
_ENGINE = dict(num_blocks=12, max_batch=2, max_seq_len=512, num_workers=2,
               chunked_prefill=True, prefill_chunk=1, admission="fcfs")


@pytest.fixture(scope="module")
def traced():
    """Both engines after the same seeded trace, each with its package's
    collector attached from construction."""
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCfg(**_TINY), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jeng = JEngine(JCfg(**_TINY), jp, config=JConfig(page_impl="ref",
                                                    **_ENGINE))
    teng = TEngine(TCfg(**_TINY), tp, config=TConfig(device="cpu",
                                                     **_ENGINE))
    out = {}
    for name, eng, collector in (("ref", jeng, JTrace), ("port", teng,
                                                         TTrace)):
        tc = collector(eng.bus)
        rng = np.random.RandomState(6)
        for i in range(5):
            eng.submit(rng.randint(1, _TINY["vocab"],
                                   size=rng.randint(20, 300)),
                       max_new_tokens=3, stream=f"s{i % 2}",
                       group_id=i % 2 + 1)
        while not eng.sched.idle and eng.steps < 10_000:
            eng.step()
        out[name] = (eng, tc)
    return out


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_trace_collector_events_match_reference(traced):
    (_, jtc), (_, ttc) = traced["ref"], traced["port"]
    cats = {e["cat"] for e in jtc.events}
    assert {"request", "prefill", "engine", "coherence"} <= cats
    # emission order is the bus's, which both control planes share
    assert _untimed(ttc.events) == _untimed(jtc.events)
    # chrome_trace() orders by time stamp: compare as multisets
    assert sorted(map(repr, _untimed(ttc.chrome_trace()["traceEvents"]))) \
        == sorted(map(repr, _untimed(jtc.chrome_trace()["traceEvents"])))
    assert ttc.summary() == jtc.summary()


def _type_lines(text: str) -> list:
    return sorted(line for line in text.splitlines()
                  if line.startswith("# TYPE"))


def test_rendered_registry_matches_reference(traced):
    (jeng, _), (teng, _) = traced["ref"], traced["port"]
    jtext = jexport.render_registry(jeng.metrics)
    ttext = texport.render_registry(teng.metrics)
    assert texport.parse_keys(ttext) == jexport.parse_keys(jtext)
    assert _type_lines(ttext) == _type_lines(jtext)
    assert len(_type_lines(ttext)) > 20


@pytest.mark.parametrize("which", ["fence-impact", "eviction", "admission"])
def test_sim_matches_reference(which):
    """One seeded configuration of each simulator, run by both copies."""
    if which == "admission":
        kw = dict(pool_blocks=48, n_requests=40, policy="deadline",
                  preempt="swap", overcommit_ratio=1.5, large_frac=0.2,
                  arrival_every=1.0, chunk_blocks=2, seed=7)
        want = jsim.admission_sim(jsim.AdmissionSimConfig(**kw))
        got = tsim.admission_sim(tsim.AdmissionSimConfig(**kw))
    else:
        kw = dict(num_blocks=256, io_workers=2, compute_workers=1,
                  mixed_workers=1, iters=60, scoped=True, seed=5,
                  reshard_iters=((20, 3),))
        if which == "eviction":
            kw = dict(num_blocks=64, iters=200, seed=5)
            want = jsim.eviction_sim(jsim.SimConfig(**kw), pg_buffer=4)
            got = tsim.eviction_sim(tsim.SimConfig(**kw), pg_buffer=4)
        else:
            want = jsim.FenceImpactSim(jsim.SimConfig(**kw)).run()
            got = tsim.FenceImpactSim(tsim.SimConfig(**kw)).run()
        assert dataclasses.is_dataclass(got)
        want, got = want.as_dict(), got.as_dict()
    assert got == want
    assert any(v for v in got.values() if isinstance(v, (int, float)))
