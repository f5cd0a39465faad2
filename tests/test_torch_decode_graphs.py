"""The decode step's piecewise graphs (``models/decode_graphs.py``) on the
CPU, where the pieces run eagerly over their static buffers: the logits
and the KV pool are bit for bit those of ``transformer._decode_step``
over 8 steps whose tables change between steps as an engine changes
them (a freed block remapped to another slot, a row at -1 for a slot
mid-prefill, a reallocated table stack), for attention and MLA
decoders with dense and MoE FFNs; every config, ``page_impl`` or mesh
the pieces do not take runs ``_decode_step``; an engine serving
through the pieces makes the tokens it makes without them; and the
``decode_graph_pct`` reader.  The capture and replay themselves run on
the card (``tests/test_torch_decode_graphs_cuda.py``)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.decode_graphs import POOLS, DecodeGraphs  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from _decode_graph_cases import edit, state  # noqa: E402

B = 4
STEPS = 8
#: (arch, params and pool dtype): granite in both dtypes, the dense
#: attention variants the pieces also take (qkv biases, a window), and
#: the MoE and MLA decoders: GQA with softmax-routed experts, MLA with
#: them (DeepSeek-V2) and with group-limited sigmoid routing over a held
#: share (DeepSeek-V3)
CASES = [("granite-3-8b", torch.float32), ("granite-3-8b", torch.bfloat16),
         ("qwen2.5-14b", torch.float32), ("h2o-danube-3-4b", torch.float32),
         ("deepseek-moe-16b", torch.float32),
         ("deepseek-v2-236b", torch.float32),
         ("deepseek-v3-671b", torch.float32),
         ("deepseek-v3-671b", torch.bfloat16)]


def _params(cfg, dtype):
    return tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=dtype)


@pytest.mark.parametrize("arch,dtype", CASES,
                         ids=[f"{a}-{str(d)[6:]}" for a, d in CASES])
def test_pieces_are_the_decode_step_bit_for_bit(arch, dtype):
    cfg = get_smoke(arch)
    params = _params(cfg, dtype)
    graphs = DecodeGraphs()
    eager, pieces = state(cfg, dtype, 1), state(cfg, dtype, 1)
    rng = np.random.RandomState(2)
    for step in range(STEPS):
        for st in (eager, pieces):
            edit(st, step)
        tok = torch.from_numpy(rng.randint(0, cfg.vocab, B).astype(np.int32))
        lg_e, eager = tfm.decode_step(params, cfg, dict(eager), tok,
                                      page_impl="kernel")
        lg_p, pieces = tfm.decode_step(params, cfg, dict(pieces), tok,
                                       page_impl="kernel", graphs=graphs)
        assert lg_p.dtype == torch.float32
        assert torch.equal(lg_p, lg_e), f"logits differ at step {step}"
        for k in POOLS:
            if k in eager:
                assert torch.equal(pieces[k], eager[k]), f"{k} at {step}"
        assert torch.equal(pieces["lengths"], eager["lengths"])
    assert graphs.steps == STEPS
    assert graphs.captures == 0           # no graphs off the card


def test_a_new_key_rebuilds_the_pieces():
    cfg = get_smoke("granite-3-8b")
    params = _params(cfg, torch.float32)
    graphs = DecodeGraphs()
    st = state(cfg, torch.float32, 3)
    tok = torch.zeros(B, dtype=torch.int32)
    tfm.decode_step(params, cfg, dict(st), tok, page_impl="kernel",
                    graphs=graphs)
    io = graphs._io
    tfm.decode_step(params, cfg, dict(st), tok, page_impl="kernel",
                    graphs=graphs)
    assert graphs._io is io
    st["kv"] = st["kv"].clone()           # a new pool: another address
    tfm.decode_step(params, cfg, dict(st), tok, page_impl="kernel",
                    graphs=graphs)
    assert graphs._io is not io
    io = graphs._io
    tfm.decode_step(_params(cfg, torch.float32), cfg, dict(st), tok,
                    page_impl="kernel", graphs=graphs)
    assert graphs._io is not io


#: (arch, page_impl, whether the pieces take it)
TAKES = [("granite-3-8b", "kernel", True), ("granite-3-8b", "ref", False),
         ("qwen2.5-14b", "kernel", True), ("h2o-danube-3-4b", "kernel", True),
         ("deepseek-v2-236b", "kernel", True),
         ("deepseek-moe-16b", "kernel", True),
         ("jamba-v0.1-52b", "kernel", False), ("rwkv6-7b", "kernel", False),
         ("whisper-small", "kernel", False)]


@pytest.mark.parametrize("arch,page_impl,want", TAKES,
                         ids=[f"{a}-{p}" for a, p, _ in TAKES])
def test_which_configs_the_pieces_take(arch, page_impl, want):
    assert DecodeGraphs.takes(get_smoke(arch), page_impl) is want


@pytest.mark.parametrize("arch,page_impl", [
    ("deepseek-v2-236b", "ref"), ("deepseek-moe-16b", "ref"),
    ("granite-3-8b", "ref"), ("jamba-v0.1-52b", "kernel")])
def test_other_steps_run_the_eager_decode_step(arch, page_impl):
    cfg = get_smoke(arch)
    params = _params(cfg, torch.float32)
    st = tfm.init_decode_state(cfg, B, 256, device="cpu")
    st["lengths"] = torch.tensor([3, 0, 7, 1], dtype=torch.int32)
    tok = torch.arange(B, dtype=torch.int32)
    graphs = DecodeGraphs()
    lg_g, st_g = tfm.decode_step(params, cfg, {k: v.clone() for k, v in
                                               st.items()}, tok,
                                 page_impl=page_impl, graphs=graphs)
    lg_e, st_e = tfm.decode_step(params, cfg, st, tok, page_impl=page_impl)
    assert graphs.steps == 0 and not graphs._io
    assert torch.equal(lg_g, lg_e)
    for k in st_e:
        assert torch.equal(st_g[k], st_e[k]), k


def test_a_mesh_runs_the_eager_decode_step(monkeypatch):
    seen = []
    monkeypatch.setattr(tfm, "_decode_step",
                        lambda *a, **k: seen.append(k["mesh"]) or "eager")
    graphs = DecodeGraphs()
    mesh = object()
    for impl in tfm.SP_IMPLS:
        out = tfm.decode_step({}, get_smoke("granite-3-8b"), {}, None,
                              page_impl=impl, mesh=mesh, graphs=graphs)
        assert out == "eager"
    assert seen == [mesh, mesh] and graphs.steps == 0


def _serve(eng, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(6):
        eng.submit(rng.randint(1, eng.cfg.vocab, size=rng.randint(20, 300)),
                   max_new_tokens=int(rng.randint(4, 24)), stream=f"s{i}")
    eng.run()
    return [list(r.generated) for r in sorted(eng.sched.done,
                                              key=lambda r: r.rid)]


@pytest.mark.parametrize("path", ["default", "chunked"])
def test_an_engine_serving_through_the_pieces_makes_the_same_tokens(path):
    cfg = get_smoke("granite-3-8b")
    params = _params(cfg, torch.float32)
    extra = {"chunked": dict(chunked_prefill=True, prefill_chunk=1)}
    conf = EngineConfig(device="cpu", num_blocks=12, max_batch=3,
                        max_seq_len=512, page_impl="kernel",
                        **extra.get(path, {}))
    plain, piecewise = Engine(cfg, params, config=conf), \
        Engine(cfg, params, config=conf)
    assert plain._graphs is None          # off the card: no graphs
    piecewise._graphs = DecodeGraphs()
    assert _serve(piecewise) == _serve(plain)
    assert piecewise._graphs.steps == plain.decode_steps > 0
    assert torch.equal(piecewise.cache.state["kv"], plain.cache.state["kv"])


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_an_mla_moe_engine_through_the_pieces_makes_the_same_tokens(arch):
    cfg = get_smoke(arch)
    params = _params(cfg, torch.float32)
    conf = EngineConfig(device="cpu", num_blocks=12, max_batch=3,
                        max_seq_len=512, page_impl="kernel")
    plain, piecewise = Engine(cfg, params, config=conf), \
        Engine(cfg, params, config=conf)
    piecewise._graphs = DecodeGraphs()
    for eng in (plain, piecewise):
        eng.enable_tracing()
    assert _serve(piecewise) == _serve(plain)
    assert piecewise._graphs.steps == plain.decode_steps > 0
    for k in ("mla_c", "mla_rope"):
        assert torch.equal(piecewise.cache.state[k], plain.cache.state[k])
    snaps = [eng.metrics.snapshot() for eng in (plain, piecewise)]
    for key in ("trace.moe.here", "trace.moe.kept", "trace.moe.slots",
                "trace.moe.rows"):
        assert snaps[1][key] == snaps[0][key] > 0, key


class _Seen:
    def moe_fill(self, slots, kept, rows, here):
        self.args = (slots, int(kept), rows, int(here))


def _handed(counts):
    seen = _Seen()
    counts.hand_to(seen)
    return seen.args


def test_the_captured_counts_are_the_dispatches_counts(monkeypatch):
    """What :class:`_Counts` hands on after a step is the sum, over the
    step's MoE dispatches, of what each hands on alone: the first
    dispatch writes the static counts, the others add."""
    from repro_torch.core import recorder as trace_rec
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.decode_graphs import _Counts
    cfg = get_smoke("deepseek-v3-671b")
    params = _params(cfg, torch.float32)
    x = torch.randn(B, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))

    def ffn(i, step):
        moe_mod.moe_ffn(tfm.layer_params(params, cfg, i)["ffn"],
                        x * (i + step), cfg)
    counts = _Counts("cpu")
    for step in range(2):
        counts.slots = counts.rows = 0          # a new step's replay
        monkeypatch.setattr(trace_rec, "ACTIVE", counts)
        for i in (2, 3):
            ffn(i, step)
        both = _handed(counts)
        got = [0, 0, 0, 0]
        for i in (2, 3):
            alone = _Counts("cpu")
            monkeypatch.setattr(trace_rec, "ACTIVE", alone)
            ffn(i, step)
            got = [g + a for g, a in zip(got, _handed(alone))]
        assert list(both) == got
        assert got[0] == 2 * B * cfg.moe.top_k and 0 < got[3] <= got[0]


class _Window:
    def __init__(self, c0, c1):
        self.counters0, self.counters1 = c0, c1

    def counter(self, key):
        return self.counters1.get(key, 0) - self.counters0.get(key, 0)


def _reader():
    path = (Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
            / "decode_graph_pct.py")
    spec = importlib.util.spec_from_file_location("decode_graph_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("c0,c1,want", [
    ({}, {"trace.decode.graph_steps": 99,
          "trace.launch.decode_step.calls": 100}, 99.0),
    ({"trace.decode.graph_steps": 10, "trace.launch.decode_step.calls": 11},
     {"trace.decode.graph_steps": 60, "trace.launch.decode_step.calls": 61},
     100.0),
    ({}, {"trace.launch.decode_step.calls": 100}, None),
    ({}, {"trace.decode.graph_steps": 0,
          "trace.launch.decode_step.calls": 0}, None)],
    ids=["from-zero", "window", "no-graphs", "no-decode"])
def test_decode_graph_pct_reader(c0, c1, want):
    assert _reader().read(_Window(c0, c1)) == want
