"""The readers of the program's own spans and counters (``trace.*`` in the
engine's snapshot, from ``repro_torch/core/recorder.py``): each gives its
value from a window's counters and nothing where the program has no
recorder; and the reduction of a profiler trace gives each idle gap to
the innermost range, where the program's ranges nest inside the
benchmark's."""

import pytest

from perfbench import harness, trace
from perfbench.window import Record

MS = 1_000_000


class _Req:
    def __init__(self, done_t):
        self.done_t = done_t


def _record(c0, c1, done=4):
    reqs = [_Req(1.0 + i) for i in range(done)] + [_Req(None), _Req(20.0)]
    return Record(cell=None, dims={}, t0=0.0, t1=10.0, setup_s=0.0,
                  reqs=reqs, counters0=c0, counters1=c1, steps=0)


# (metric, counters at the window's start, at its end, expected value)
CASES = [
    ("launch_ms_per_step",
     {"trace.engine.launch_s": 1.0, "trace.engine.steps": 10},
     {"trace.engine.launch_s": 4.0, "trace.engine.steps": 60}, 60.0),
    ("host_wait_pct",
     {"trace.engine.wait_s": 0.5, "trace.engine.step_s": 2.0},
     {"trace.engine.wait_s": 1.5, "trace.engine.step_s": 6.0}, 25.0),
    ("fence_ms_per_req", {"trace.cache.fence_s": 0.001},
     {"trace.cache.fence_s": 0.005}, 1.0),
    ("ragged_useful_pct",
     {"trace.ragged.rows_real": 100, "trace.ragged.rows_cap": 2048},
     {"trace.ragged.rows_real": 700, "trace.ragged.rows_cap": 4096},
     100.0 * 600 / 2048),
    ("moe_fill_pct", {"trace.moe.kept": 0, "trace.moe.rows": 0},
     {"trace.moe.kept": 192, "trace.moe.rows": 640}, 30.0),
]


@pytest.mark.parametrize("name,c0,c1,want", CASES, ids=[c[0] for c in CASES])
def test_reader_gives_the_window_value(name, c0, c1, want):
    assert harness.reader(name).read(_record(c0, c1)) == pytest.approx(want)


@pytest.mark.parametrize("name,c0,c1,want", CASES, ids=[c[0] for c in CASES])
def test_reader_gives_the_value_when_the_recorder_started_in_the_window(
        name, c0, c1, want):
    """A profiled step switches the recorder on, so the window's first
    snapshot may hold no ``trace.*`` key: the window's totals are then the
    last snapshot's."""
    got = harness.reader(name).read(_record({}, c1))
    assert got == pytest.approx(harness.reader(name).read(
        _record(dict.fromkeys(c0, 0), c1)))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_gives_nothing_without_the_recorder(name):
    counters = {"fence.fences": 3, "engine.steps": 10}
    assert harness.reader(name).read(_record(counters, counters)) is None


def test_readers_give_nothing_for_an_empty_window():
    zero = {k: 0 for _, _, c1, _ in CASES for k in c1}
    for name, *_ in CASES:
        assert harness.reader(name).read(_record(zero, zero, done=0)) is None


def _nested_events():
    """The benchmark's ranges (``engine.step``, ``admission``,
    ``decode_step``, ``kernel.paged_decode``) around and inside the
    program's (``engine.*``, ``model.*``), as in a traced run."""
    a = "annotation"
    return [
        (a, trace.WINDOW, 0, 100 * MS, None),
        (a, "engine.step", 10 * MS, 90 * MS, None),        # benchmark
        (a, "engine.step", 10 * MS + 10, 90 * MS - 10, None),  # program
        (a, "engine.admit", 10 * MS + 20, 20 * MS, None),
        (a, "admission", 10 * MS + 30, 19 * MS, None),     # benchmark
        (a, "engine.launch", 20 * MS, 60 * MS, None),
        (a, "decode_step", 20 * MS + 10, 60 * MS - 10, None),  # benchmark
        (a, "model.attn", 20 * MS + 20, 40 * MS, None),
        (a, "kernel.paged_decode", 25 * MS, 26 * MS, None),  # benchmark
        (a, "model.moe", 40 * MS, 60 * MS - 20, None),
        (a, "engine.wait", 60 * MS, 70 * MS, None),
        (a, "engine.emit", 70 * MS, 90 * MS - 20, None),
        ("launch", "cudaLaunchKernel", 25 * MS, 25 * MS + 10, 1),
        ("device", "paged_attention::paged_decode_kernel<1, float, float>"
         "(float const*)", 25 * MS + 500_000, 28 * MS, 1),
        ("device", "nvjet_gemm", 30 * MS, 45 * MS, None),
        ("device", "nvjet_gemm", 50 * MS, 65 * MS, None),
        ("device", "Memcpy DtoH", 65 * MS, 66 * MS, None),
    ]


def test_idle_gaps_go_to_the_innermost_program_range():
    r = trace.reduce(_nested_events())
    gaps = r["idle_gaps"]
    # 0-25.5 ms began before any range; 28-30 inside model.attn (inside
    # the benchmark's decode_step); 45-50 inside model.moe; 66-100 inside
    # engine.wait, then past the step
    assert gaps[trace.OUTSIDE] == pytest.approx(0.0255)
    assert gaps["model.attn"] == pytest.approx(0.002)
    assert gaps["model.moe"] == pytest.approx(0.005)
    assert gaps["engine.wait"] == pytest.approx(0.034)
    assert "decode_step" not in gaps and "engine.launch" not in gaps
    assert r["kernel_time"] == {"paged_decode": pytest.approx(0.0025)}
    assert "paged_attention::paged_decode_kernel<1, float, float>" in \
        r["kernels"]
