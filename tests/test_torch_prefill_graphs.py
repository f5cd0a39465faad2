"""The monolithic prefill's CUDA graphs (``models/prefill_graphs.py``) on
the CPU, where each padded length's body runs eagerly over its static
buffers: the logits, the pools and the lengths are bit for bit those of
``transformer.prefill`` at three padded lengths, over calls whose table
row an engine rewrites in place between them, for granite's, DeepSeek-
V2's and DeepSeek-V3's smoke configs; a new key drops the graphs; a
hybrid, an encoder-decoder, a vision prefix and a mesh call run the
eager ``_prefill``; an engine serving its prefills through the graphs
makes the tokens it makes without them; the recorder's counters; and
the ``prefill_graph_pct`` reader.  The capture and replay themselves
run on the card (``tests/test_torch_prefill_graphs_cuda.py``)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import recorder as trace_rec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.decode_graphs import POOLS  # noqa: E402
from repro_torch.models.prefill_graphs import PrefillGraphs  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from _prefill_graph_cases import remap, state  # noqa: E402

ARCHS = ["granite-3-8b", "deepseek-v2-236b", "deepseek-v3-671b"]
LENGTHS = [128, 256, 512]
BS = tfm.BLOCK_SIZE


def _params(cfg, dtype=torch.float32, seed=0):
    return tfm.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                           device="cpu", dtype=dtype)


def _same(got, want, what):
    (lg_g, st_g), (lg_e, st_e) = got, want
    assert lg_g.dtype == torch.float32
    assert torch.equal(lg_g, lg_e), f"logits differ at {what}"
    for k in st_e:
        assert torch.equal(st_g[k], st_e[k]), f"{k} differs at {what}"


@pytest.mark.parametrize("Sp", LENGTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_graph_body_is_the_prefill_bit_for_bit(arch, Sp):
    """Calls at ``Sp`` and at another padded length in turn, the table
    row rewritten in place before every call after the first."""
    cfg = get_smoke(arch)
    params = _params(cfg)
    graphs = PrefillGraphs()
    eager, graph = state(cfg, torch.float32, 1), state(cfg, torch.float32, 1)
    rng = np.random.RandomState(Sp)
    other = LENGTHS[(LENGTHS.index(Sp) + 1) % len(LENGTHS)]
    calls = [Sp, other, Sp, Sp]
    for call, n in enumerate(calls):
        if call:
            for st in (eager, graph):
                remap(st, call)
        S = n - int(rng.randint(0, BS // 2))        # the prompt, padded
        tok = np.zeros((1, n), np.int32)
        tok[0, :S] = rng.randint(1, cfg.vocab, S)
        tok = torch.from_numpy(tok)
        want = tfm.prefill(params, cfg, tok, dict(eager))
        got = tfm.prefill(params, cfg, tok, dict(graph), graphs=graphs)
        _same(got, want, f"call {call} (Sp {n})")
        for k in POOLS:                  # the pools were written in place
            if k in eager:
                assert torch.equal(graph[k], eager[k]), k
    assert graphs.calls == len(calls)
    assert sorted(graphs._graphs) == sorted({(1, n) for n in calls})
    assert graphs.captures == 0           # no graphs off the card


def test_a_new_key_drops_the_graphs():
    cfg = get_smoke("granite-3-8b")
    params = _params(cfg)
    graphs = PrefillGraphs()
    st = state(cfg, torch.float32, 2)
    tok = torch.ones((1, BS), dtype=torch.int32)
    tfm.prefill(params, cfg, tok, dict(st), graphs=graphs)
    g = graphs._graphs[(1, BS)]
    tfm.prefill(params, cfg, torch.ones((1, 2 * BS), dtype=torch.int32),
                dict(st), graphs=graphs)
    tfm.prefill(params, cfg, tok, dict(st), graphs=graphs)
    assert graphs._graphs[(1, BS)] is g and len(graphs._graphs) == 2
    st["kv"] = st["kv"].clone()           # a new pool: another address
    tfm.prefill(params, cfg, tok, dict(st), graphs=graphs)
    assert graphs._graphs[(1, BS)] is not g and len(graphs._graphs) == 1
    g = graphs._graphs[(1, BS)]
    tfm.prefill(_params(cfg), cfg, tok, dict(st), graphs=graphs)
    assert graphs._graphs[(1, BS)] is not g


#: (arch, whether the graphs take its prefill)
TAKES = [("granite-3-8b", True), ("qwen2.5-14b", True),
         ("h2o-danube-3-4b", True), ("deepseek-moe-16b", True),
         ("deepseek-v2-236b", True), ("deepseek-v3-671b", True),
         ("internvl2-26b", True), ("jamba-v0.1-52b", False),
         ("rwkv6-7b", False), ("whisper-small", False)]


@pytest.mark.parametrize("arch,want", TAKES, ids=[a for a, _ in TAKES])
def test_which_configs_the_graphs_take(arch, want):
    assert PrefillGraphs.takes(get_smoke(arch)) is want


def _inputs(cfg, seed=3):
    """A (1, 256) prompt and the frames or patches the config takes."""
    rng = np.random.RandomState(seed)
    tok = torch.from_numpy(rng.randint(1, cfg.vocab, (1, 2 * BS))
                           .astype(np.int32))
    kw = {}
    if cfg.enc_dec:
        kw["enc_frames"] = torch.from_numpy(
            rng.randn(1, cfg.enc_len, cfg.d_model).astype(np.float32))
    if cfg.frontend == "vision":
        kw["patches"] = torch.from_numpy(
            rng.randn(1, 16, cfg.d_model).astype(np.float32))
    return tok, kw


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b",
                                  "whisper-small", "internvl2-26b"])
def test_other_prefills_run_the_eager_prefill(arch):
    """A hybrid's per-slot recurrent state, an encoder's frames and a
    vision prefix keep the eager body."""
    cfg = get_smoke(arch)
    params = _params(cfg)
    tok, kw = _inputs(cfg)
    st = tfm.init_decode_state(cfg, 1, 4 * BS, device="cpu")
    graphs = PrefillGraphs()
    got = tfm.prefill(params, cfg, tok, {k: v.clone() for k, v in
                                         st.items()}, graphs=graphs, **kw)
    want = tfm.prefill(params, cfg, tok, st, **kw)
    assert graphs.calls == 0 and not graphs._graphs
    _same(got, want, arch)


def test_a_mesh_or_a_layout_runs_the_eager_prefill(monkeypatch):
    seen = []
    monkeypatch.setattr(tfm, "_prefill",
                        lambda *a, **k: seen.append(k["mesh"]) or "eager")

    class Layout:
        mesh = object()

        def top(self, params):
            return params
    graphs = PrefillGraphs()
    cfg = get_smoke("granite-3-8b")
    mesh, layout = object(), Layout()
    assert tfm.prefill({}, cfg, None, {}, mesh=mesh,
                       graphs=graphs) == "eager"
    assert tfm.prefill({}, cfg, None, {}, layout=layout,
                       graphs=graphs) == "eager"
    assert seen == [mesh, layout.mesh] and graphs.calls == 0


def _serve(eng, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(6):
        eng.submit(rng.randint(1, eng.cfg.vocab, size=rng.randint(20, 300)),
                   max_new_tokens=int(rng.randint(4, 16)), stream=f"s{i}")
    eng.run()
    return [list(r.generated) for r in sorted(eng.sched.done,
                                              key=lambda r: r.rid)]


@pytest.mark.parametrize("arch", ARCHS)
def test_an_engine_prefilling_through_the_graphs_makes_the_same_tokens(
        arch):
    cfg = get_smoke(arch)
    params = _params(cfg)
    conf = EngineConfig(device="cpu", num_blocks=12, max_batch=3,
                        max_seq_len=512, page_impl="kernel")
    plain, graphed = Engine(cfg, params, config=conf), \
        Engine(cfg, params, config=conf)
    assert plain._prefill_graphs is None  # off the card: no graphs
    graphed._prefill_graphs = PrefillGraphs()
    for eng in (plain, graphed):
        eng.enable_tracing()
    assert _serve(graphed) == _serve(plain)
    snaps = [eng.metrics.snapshot() for eng in (plain, graphed)]
    assert graphed._prefill_graphs.calls == \
        snaps[1]["trace.launch.prefill.calls"] == 6
    for k in POOLS:
        if k in plain.cache.state:
            assert torch.equal(graphed.cache.state[k], plain.cache.state[k])
    moe = ("trace.moe.here", "trace.moe.kept", "trace.moe.slots",
           "trace.moe.rows")
    for key in moe if "moe" in cfg.ffns else ():
        assert snaps[1][key] == snaps[0][key] > 0, key


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v3-671b"])
def test_an_engine_holds_graphs_only_where_they_serve(arch):
    """Off the card, and on the chunked paths, an engine holds none."""
    cfg = get_smoke(arch)
    params = _params(cfg)
    for extra in ({}, dict(chunked_prefill=True, prefill_chunk=1)):
        eng = Engine(cfg, params, config=EngineConfig(
            device="cpu", num_blocks=12, max_batch=3, max_seq_len=512,
            page_impl="kernel", **extra))
        assert eng._prefill_graphs is None


def test_the_recorder_counts_replays_and_captures():
    rec = trace_rec.SpanRecorder("cpu")
    for captured in (True, False, False, True, False):
        rec.prefill_graph(captured=captured)
    out = rec.counters()
    assert out["prefill"] == {"captures": 2, "graph_calls": 3}
    assert {"trace.prefill.captures", "trace.prefill.graph_calls"} <= set(
        trace_rec.TRACE_SCHEMA)


class _Window:
    def __init__(self, c0, c1):
        self.counters0, self.counters1 = c0, c1

    def counter(self, key):
        return self.counters1.get(key, 0) - self.counters0.get(key, 0)


def _reader():
    path = (Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
            / "prefill_graph_pct.py")
    spec = importlib.util.spec_from_file_location("prefill_graph_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("c0,c1,want", [
    ({}, {"trace.prefill.graph_calls": 99,
          "trace.launch.prefill.calls": 100}, 99.0),
    ({"trace.prefill.graph_calls": 10, "trace.launch.prefill.calls": 18},
     {"trace.prefill.graph_calls": 60, "trace.launch.prefill.calls": 68},
     100.0),
    ({}, {"trace.launch.prefill.calls": 100}, None),
    ({}, {"trace.prefill.graph_calls": 0,
          "trace.launch.prefill.calls": 0}, None)],
    ids=["from-zero", "window", "no-graphs", "no-prefill"])
def test_prefill_graph_pct_reader(c0, c1, want):
    assert _reader().read(_Window(c0, c1)) == want
