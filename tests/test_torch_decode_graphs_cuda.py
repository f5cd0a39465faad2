"""On the card: the decode step's piecewise CUDA graphs
(``models/decode_graphs.py``) captured and replayed.  Over 64 greedy steps
whose tables change between steps (``_decode_graph_cases.edit``) the
replayed step makes the eager ``_decode_step``'s tokens (the largest
|logit difference| is printed: the kernels and shapes are the same); a
reshard's new stack shape captures once more and no other step does; an
engine's ``trace.decode.graph_steps`` counts the replays, and an MLA and
MoE engine's replays make the eager engine's tokens and hand the
recorder the same MoE slot counts (``trace.moe.*``); and under
replay the profiler still finds every paged-decode kernel launched inside
``ops.paged_attention_fused_fwd``, where the benchmark credits it.  These
skip without a CUDA device; on a machine with one run them with
``python -m pytest -q -s -m cuda tests/test_torch_decode_graphs_cuda.py``
(the file imports no JAX)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.decode_graphs import POOLS, DecodeGraphs  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from _decode_graph_cases import M, edit, state  # noqa: E402
from _torch_cases import shard_stack  # noqa: E402

STEPS = 64


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import _build
    _build.build_all()
    return torch.device("cuda")


def _config(name):
    """The granite smoke config, DeepSeek-V2's or -V3's, granite-3-8b at
    its published widths cut to 2 layers, or DeepSeek-V3 at its
    published widths cut to one dense and one MoE layer."""
    smoke = {"smoke": "granite-3-8b", "v2-smoke": "deepseek-v2-236b",
             "v3-smoke": "deepseek-v3-671b"}
    if name in smoke:
        return get_smoke(smoke[name])
    if name == "v3-2l":
        full = get_config("deepseek-v3-671b")
        return full.with_(n_layers=2, mixers=full.mixers[:2],
                          ffns=("dense", "moe"))
    full = get_config("granite-3-8b")
    return full.with_(n_layers=2, mixers=full.mixers[:2],
                      ffns=full.ffns[:2])


def _params(cfg, dtype, dev):
    return tfm.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                           device=dev, dtype=dtype)


CASES = [("smoke", torch.float32, 4), ("smoke", torch.bfloat16, 4),
         ("granite-2l", torch.bfloat16, 32), ("v2-smoke", torch.float32, 4),
         ("v3-smoke", torch.float32, 4), ("v3-2l", torch.bfloat16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,B", CASES,
                         ids=[f"{n}-{str(d)[6:]}-B{b}" for n, d, b in CASES])
def test_replayed_steps_make_the_eager_tokens_on_card(cuda, name, dtype, B):
    cfg = _config(name)
    params = _params(cfg, dtype, cuda)
    graphs = DecodeGraphs()
    eager, replay = (state(cfg, dtype, 1, B, cuda) for _ in range(2))
    tok_e = tok_r = torch.arange(B, dtype=torch.int32, device=cuda)
    worst = 0.0
    with torch.no_grad():
        for step in range(STEPS):
            for st in (eager, replay):
                edit(st, step)
            lg_e, eager = tfm.decode_step(params, cfg, dict(eager), tok_e,
                                          page_impl="kernel")
            lg_r, replay = tfm.decode_step(params, cfg, dict(replay), tok_r,
                                           page_impl="kernel", graphs=graphs)
            worst = max(worst, (lg_r - lg_e).abs().max().item())
            tok_e = lg_e.argmax(-1).to(torch.int32)
            tok_r = lg_r.argmax(-1).to(torch.int32)
            assert torch.equal(tok_r, tok_e), f"tokens differ at {step}"
    pool = max((replay[k].float() - eager[k].float()).abs().max().item()
               for k in POOLS if k in eager)
    print(f"\n{name} {dtype} B {B}: {STEPS} steps, largest |dlogit| "
          f"{worst:.3g}, largest |dpool| {pool:.3g}")
    assert graphs.captures == 1 and graphs.steps == STEPS


@pytest.mark.cuda
def test_a_reshard_captures_once_more_on_card(cuda):
    cfg = _config("smoke")
    params = _params(cfg, torch.float32, cuda)
    graphs = DecodeGraphs()
    eager, replay = (state(cfg, torch.float32, 2, 8, cuda) for _ in range(2))
    tok = torch.arange(8, dtype=torch.int32, device=cuda)
    with torch.no_grad():
        for step in range(12):
            if step == 5:        # the stack goes from 2 shards to 4
                for st in (eager, replay):
                    tab = attn_mod.assemble_shard_tables(st["tables"])
                    st["tables"] = torch.from_numpy(shard_stack(
                        tab.cpu().numpy(), 4)).to(cuda)
            lg_e, eager = tfm.decode_step(params, cfg, dict(eager), tok,
                                          page_impl="kernel")
            lg_r, replay = tfm.decode_step(params, cfg, dict(replay), tok,
                                           page_impl="kernel", graphs=graphs)
            assert torch.equal(lg_r.argmax(-1), lg_e.argmax(-1))
            assert graphs.captures == (1 if step < 5 else 2)
            tok = lg_e.argmax(-1).to(torch.int32)
    assert graphs.steps == 12


def _engine(params, cfg, dev):
    conf = EngineConfig(device=str(dev), num_blocks=48, max_batch=4,
                        max_seq_len=M * tfm.BLOCK_SIZE, page_impl="kernel")
    return Engine(cfg, params, config=conf)


def _submit(eng, seed=0, n=8):
    rng = np.random.RandomState(seed)
    for i in range(n):
        eng.submit(rng.randint(1, eng.cfg.vocab, size=rng.randint(20, 300)),
                   max_new_tokens=int(rng.randint(8, 40)), stream=f"s{i}")


@pytest.mark.cuda
def test_the_engine_counts_its_replays_on_card(cuda):
    cfg = _config("smoke")
    params = _params(cfg, torch.float32, cuda)
    runs = {}
    for graphs in (True, False):
        eng = _engine(params, cfg, cuda)
        assert isinstance(eng._graphs, DecodeGraphs)
        if not graphs:
            eng._graphs = None
        eng.enable_tracing()
        _submit(eng)
        eng.run()
        runs[graphs] = (eng, [list(r.generated) for r in sorted(
            eng.sched.done, key=lambda r: r.rid)])
    eng, tokens = runs[True]
    assert tokens == runs[False][1]
    snap = eng.metrics.snapshot()
    assert eng._graphs.captures == 1 == snap["trace.decode.captures"]
    assert snap["trace.decode.graph_steps"] == eng.decode_steps - 1 > 0
    assert snap["trace.launch.decode_step.calls"] == eng.decode_steps
    off = runs[False][0].metrics.snapshot()
    assert off["trace.decode.graph_steps"] == off["trace.decode.captures"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["v2-smoke", "v3-smoke"])
def test_an_mla_moe_engine_replays_and_counts_its_moe_slots_on_card(
        cuda, name):
    cfg = _config(name)
    params = _params(cfg, torch.float32, cuda)
    runs = []
    for graphs in (True, False):
        eng = _engine(params, cfg, cuda)
        assert isinstance(eng._graphs, DecodeGraphs)
        if not graphs:
            eng._graphs = None
        eng.enable_tracing()
        _submit(eng, n=4)
        eng.run()
        runs.append((eng.metrics.snapshot(), eng.decode_steps, [
            list(r.generated) for r in sorted(eng.sched.done,
                                              key=lambda r: r.rid)]))
    (snap, steps, tokens), (off, _, off_tokens) = runs
    assert tokens == off_tokens
    assert snap["trace.launch.decode_step.calls"] == steps > 1
    assert snap["trace.decode.graph_steps"] == steps - 1
    assert snap["trace.decode.captures"] == 1
    for key in ("trace.moe.here", "trace.moe.kept", "trace.moe.slots",
                "trace.moe.rows"):
        assert snap[key] == off[key] > 0, key


@pytest.mark.cuda
def test_replayed_steps_launch_the_kernel_inside_its_wrapper_on_card(
        cuda, tmp_path):
    import json

    from repro_torch.kernels.paged_attention import ops as pa_ops
    cfg = _config("smoke")
    params = _params(cfg, torch.float32, cuda)
    eng = _engine(params, cfg, cuda)
    _submit(eng, seed=1)
    for _ in range(3):               # the first decode step captures
        eng.step()
    assert eng._graphs.captures == 1
    inner = pa_ops.paged_attention_fused_fwd
    rf = torch.profiler.record_function

    def wrapped(*a, **k):
        with rf("kernel.paged_decode"):
            return inner(*a, **k)
    pa_ops.paged_attention_fused_fwd = wrapped
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        steps = eng.decode_steps
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(4):
                eng.step()
            torch.cuda.synchronize()
        steps = eng.decode_steps - steps
    finally:
        pa_ops.paged_attention_fused_fwd = inner
    assert steps >= 2
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("name") == "kernel.paged_decode"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                         "cuda_driver")
              and "correlation" in e.get("args", {})}
    kern = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel"
            and "paged_decode_kernel" in e.get("name", "")]
    assert len(kern) == steps * cfg.n_layers
    for e in kern:
        t = launch[e["args"]["correlation"]]
        assert any(s <= t <= f for s, f in ranges), "launched outside"
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert "model.graph" in names and "model.attn" in names
    # the pieces' own kernels ran too: the graphs' replays are traced
    graph_kernels = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "kernel"
                     and "paged_decode_kernel" not in e.get("name", "")
                     and "merge_kernel" not in e.get("name", "")]
    assert len(graph_kernels) > steps * cfg.n_layers
