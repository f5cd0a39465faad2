"""The port's in-program span recorder (``core/recorder.py``) on the
engine's three paths at smoke sizes, on the CPU (host stand-ins for the
CUDA events): off, it leaves the snapshot and the bus alone; on, the
phases nest inside their step, the ragged and MoE counters equal what
the host recomputes, a fence nests under the phase that issued it, the
Chrome export merges a collector's events on the profiler's time base,
a profiled step switches the recorder on and its spans share the
profiler's clock, and the exporter renders ``trace.*`` with its kinds."""

from __future__ import annotations

import json
import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import export  # noqa: E402
from repro_torch.core import recorder as trace_rec  # noqa: E402
from repro_torch.core.events import FenceIssued  # noqa: E402
from repro_torch.core.tracing import TraceCollector  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

TINY = ModelConfig(name="tiny", n_layers=2, d_model=32, n_heads=2,
                   n_kv_heads=1, d_ff=64, vocab=64, head_dim=16)
#: the engine's three paths: monolithic prefill + decode, chunked
#: prefill, the ragged step
PATHS = {"default": {},
         "chunked": dict(chunked_prefill=True, prefill_chunk=1),
         "ragged": dict(chunked_prefill=True, prefill_chunk=1,
                        ragged_kernel=True)}
PHASES = {"engine.admit", "engine.settle", "engine.grow", "engine.tables",
          "engine.inputs", "engine.launch", "engine.wait", "engine.emit"}


def _params(cfg):
    return tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)


def _engine(cfg=TINY, params=None, **kw):
    conf = dict(device="cpu", num_blocks=24, max_batch=2, max_seq_len=256)
    conf.update(kw)
    return Engine(cfg, params if params is not None else _params(cfg),
                  config=EngineConfig(**conf))


def _serve(eng, n=4, seed=0, new=4, groups=None):
    rng = np.random.RandomState(seed)
    for i in range(n):
        eng.submit(rng.randint(1, eng.cfg.vocab, size=rng.randint(20, 150)),
                   max_new_tokens=new, stream=f"s{i}",
                   group_id=(groups or (lambda i: i + 1))(i))
    eng.run()
    return [list(r.generated) for r in sorted(eng.sched.done,
                                              key=lambda r: r.rid)]


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


@pytest.mark.parametrize("path", PATHS)
def test_recorder_off_leaves_snapshot_and_collector_alone(path):
    params = _params(TINY)
    runs = {}
    for on in (False, True):
        eng = _engine(params=params, **PATHS[path])
        tc = TraceCollector(eng.bus)
        if on:
            eng.enable_tracing()
        runs[on] = (eng, tc, _serve(eng))
    eng, tc, tokens = runs[False]
    assert eng._rec is None and trace_rec.ACTIVE is None
    assert not [k for k in eng.metrics.snapshot() if k.startswith("trace.")]
    assert not [e for e in tc.chrome_trace()["traceEvents"]
                if e.get("cat") == "span"]
    # the recorder changes neither the tokens nor what the bus carries
    assert runs[True][2] == tokens
    assert _untimed(runs[True][1].events) == _untimed(tc.events)


@pytest.mark.parametrize("path", PATHS)
def test_phases_nest_inside_their_step(path):
    eng = _engine(**PATHS[path])
    rec = eng.enable_tracing()
    _serve(eng)
    spans = {s.id: s for s in rec.spans}
    steps = [s for s in spans.values() if s.name == "engine.step"]
    assert len(steps) == eng.steps or len(steps) == eng.steps + 1
    for st in steps:
        kids = [s for s in spans.values() if s.parent == st.id]
        assert kids and {s.name for s in kids} <= PHASES
        assert all(st.t0 <= s.t0 <= s.t1 <= st.t1 for s in kids)
        assert sum(s.t1 - s.t0 for s in kids) <= st.t1 - st.t0
    for s in spans.values():          # every span has its step above it
        p = s
        while p.parent is not None:
            p = spans[p.parent]
        assert p.name == "engine.step"
    snap = eng.metrics.snapshot()
    assert snap["trace.engine.steps"] == len(steps)
    launches = [s for s in spans.values() if s.name == "engine.launch"]
    assert snap["trace.engine.launches"] == len(launches)
    assert snap["trace.engine.launch_s"] == pytest.approx(
        sum(s.t1 - s.t0 for s in launches) / 1e9)
    assert all(s.events is not None and s.device_ms() >= 0
               for s in launches)
    for e in trace_rec.ENTRIES:
        mine = [s for s in launches if s.args["entry"] == e]
        assert snap[f"trace.launch.{e}.calls"] == len(mine)
        assert snap[f"trace.launch.{e}.device_s"] == pytest.approx(
            sum(s.device_ms() for s in mine) / 1e3)
    assert {s.args["entry"] for s in launches} == {
        "default": {"prefill", "decode_step"},
        "chunked": {"prefill_chunk", "decode_step"},
        "ragged": {"ragged_step"}}[path]
    # a step's rids are those its launches served
    for st in steps:
        served = {r for s in launches if s.parent == st.id
                  for r in s.args["rids"]}
        assert set(st.args.get("rids", ())) >= served


def test_ragged_rows_real_counts_the_descriptors(monkeypatch):
    seen = []
    build = pa_ops.build_ragged_descriptor

    def spy(*a, **k):
        d = build(*a, **k)
        seen.append(d)
        return d
    monkeypatch.setattr(pa_ops, "build_ragged_descriptor", spy)
    eng = _engine(**PATHS["ragged"])
    eng.enable_tracing()
    _serve(eng)
    snap = eng.metrics.snapshot()
    assert seen
    assert snap["trace.ragged.rows_real"] == sum(
        int((d["token_src"] >= 0).sum()) for d in seen)
    assert snap["trace.ragged.rows_cap"] == len(seen) * eng._t_cap
    assert snap["trace.ragged.rows_real"] < snap["trace.ragged.rows_cap"]


def test_moe_kept_equals_the_host_recount_of_the_routing(monkeypatch):
    host = {"kept": 0, "slots": 0, "rows": 0}
    dispatch = moe_mod._dispatch_compute

    def spy(x, gates, eidx, w_gate, w_up, w_down, capacity, num_experts,
            first=0):
        El = w_gate.shape[0]
        counts = np.bincount(eidx.reshape(-1).numpy(),
                             minlength=num_experts)[first:first + El]
        host["kept"] += int(np.minimum(counts, capacity).sum())
        host["slots"] += eidx.numel()
        host["rows"] += El * capacity
        return dispatch(x, gates, eidx, w_gate, w_up, w_down, capacity,
                        num_experts, first)
    monkeypatch.setattr(moe_mod, "_dispatch_compute", spy)
    cfg = get_smoke("deepseek-v2-236b")
    eng = _engine(cfg, max_batch=8, num_blocks=40)
    rec = eng.enable_tracing()
    _serve(eng, n=3, new=6)
    snap = eng.metrics.snapshot()
    assert snap["trace.moe.kept"] == host["kept"]
    assert snap["trace.moe.slots"] == host["slots"]
    assert snap["trace.moe.rows"] == host["rows"]
    # padding and idle slots route alike, so capacity drops some slots
    assert 0 < host["kept"] < host["slots"]
    moes = [s for s in rec.spans if s.name == "model.moe"]
    assert len(moes) == 2 * snap["trace.engine.launches"]
    for e in ("prefill", "decode_step"):
        assert snap[f"trace.launch.{e}.moe_s"] == pytest.approx(sum(
            s.device_ms() for s in moes if s.args["entry"] == e) / 1e3)
        assert 0 < snap[f"trace.launch.{e}.moe_s"] < \
            snap[f"trace.launch.{e}.device_s"]


@pytest.mark.parametrize("fpr", [False, True], ids=["baseline", "fpr"])
def test_a_fence_nests_under_the_phase_that_issued_it(fpr):
    eng = _engine(fpr_enabled=fpr, num_blocks=16)
    rec = eng.enable_tracing()
    issued = []
    # subscribed after the cache, so the fence's own span is closed here
    # and the innermost open span is the one the fence was issued in
    eng.bus.subscribe(FenceIssued,
                      lambda e: issued.append(rec._stack[-1].name))
    _serve(eng, n=6, groups=lambda i: i % 3 + 1)
    spans = {s.id: s for s in rec.spans}
    fences = [s for s in spans.values() if s.name == "cache.fence"]
    assert fences and len(fences) == len(issued)
    assert [spans[s.parent].name for s in fences] == issued
    assert set(issued) <= PHASES
    drains = [s for s in spans.values() if s.name == "cache.fence.drain"]
    assert sorted(spans[s.parent].id for s in drains) == sorted(
        s.id for s in fences)
    snap = eng.metrics.snapshot()
    assert snap["trace.cache.fences"] == len(fences) == snap["fence.fences"]
    assert snap["trace.cache.fence_s"] >= snap["trace.cache.drain_s"] > 0


def test_chrome_export_merges_the_collector_on_the_profiler_base(tmp_path):
    eng = _engine(**PATHS["chunked"])
    tc = TraceCollector(eng.bus)
    rec = eng.enable_tracing()
    _serve(eng)
    out = json.loads(open(rec.save(str(tmp_path / "t.json"), tc)).read())
    assert out["baseTimeNanoseconds"] == rec.base_ns == \
        trace_rec.profiler_base_ns(rec.base_ns + 1)
    events = [e for e in out["traceEvents"] if e["ph"] != "M"]
    mine = [e for e in events if e.get("cat") == "span"]
    assert len(mine) == len(rec.spans)
    assert {e["name"] for e in mine} >= {"engine.step", "engine.launch"}
    assert all("device_ms" in e["args"] for e in mine
               if e["name"] == "engine.launch")
    theirs = [e for e in events if e.get("cat") != "span"]
    assert sorted(map(json.dumps, _untimed(theirs))) == sorted(
        map(json.dumps, _untimed(tc.events)))
    # the collector's step spans (the engine's own clock) and the
    # recorder's land within a millisecond of each other
    a = sorted(e["ts"] for e in theirs if e["name"] == "engine.step")
    b = sorted(e["ts"] for e in mine if e["name"] == "engine.step"
               and e["args"].get("rids"))
    assert len(a) == len(b) and max(abs(x - y) for x, y in zip(a, b)) < 1e3
    bad = TraceCollector(eng.bus, clock=lambda: 0.0)
    with pytest.raises(ValueError, match="own clock"):
        rec.chrome_trace(bad)


def test_a_profiled_step_switches_the_recorder_on_on_the_profilers_clock(
        tmp_path):
    eng = _engine(**PATHS["ragged"])
    assert eng._rec is None
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU]) as p:
        _serve(eng)
    rec = eng._rec
    assert rec is not None and "trace.engine.steps" in eng.metrics.snapshot()
    path = tmp_path / "prof.json"
    p.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    ann = [e for e in trace["traceEvents"]
           if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in ann}
    assert {"engine.step", "engine.admit", "engine.tables", "engine.launch",
            "engine.wait", "model.embed", "model.attn", "model.ffn",
            "model.head"} <= names
    assert not [n for n in names if n.startswith("kernel.")]
    base = trace.get("baseTimeNanoseconds", 0)
    prof_steps = sorted(e["ts"] + base / 1e3 for e in ann
                        if e["name"] == "engine.step")
    mine = sorted(rec.profiler_us(s.t0) + rec.base_ns / 1e3
                  for s in rec.spans if s.name == "engine.step")
    assert len(prof_steps) == len(mine)
    diffs = [abs(x - y) for x, y in zip(prof_steps, mine)]
    assert statistics.median(diffs) < 100.0          # microseconds


def test_exporter_renders_the_trace_keys_with_their_kinds():
    eng = _engine()
    eng.enable_tracing()
    _serve(eng, n=2)
    keys = {k for k in eng.metrics.snapshot() if k.startswith("trace.")}
    assert keys == set(trace_rec.TRACE_SCHEMA)
    text = export.render_registry(eng.metrics)
    assert "# TYPE repro_trace_engine_launch_s_total counter" in text
    assert "# TYPE repro_trace_spans_kept gauge" in text
    assert keys <= export.parse_keys(text)
    eng.disable_tracing()
    assert not [k for k in eng.metrics.snapshot() if k.startswith("trace.")]
    assert eng.cache._rec is None
