"""On the card: the monolithic prefill's CUDA graphs
(``models/prefill_graphs.py``) captured and replayed.  At granite-3-8b's
and DeepSeek-V3's published widths cut to two layers in bf16, over three
padded lengths called in turn, the table row rewritten in place before
each call (``_prefill_graph_cases.remap``), a replayed prefill's logits
and pools equal the eager ``transformer.prefill``'s bit for bit (the
largest differences are printed) and each padded length captures
once; a pool at a new address captures again; and an engine's
``trace.prefill.graph_calls`` counts the prefills its replays served,
with the tokens and MoE slot counts of an engine without the graphs.
These skip without a CUDA device; on a machine with one run them with
``python -m pytest -q -s -m cuda tests/test_torch_prefill_graphs_cuda.py``
(the file imports no JAX)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.decode_graphs import POOLS  # noqa: E402
from repro_torch.models.prefill_graphs import PrefillGraphs  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from _prefill_graph_cases import remap, state  # noqa: E402

BS = tfm.BLOCK_SIZE
LENGTHS = [128, 384, 1024]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    from repro_torch.kernels import _build
    _build.build_all()
    return torch.device("cuda")


def _config(name):
    """The smoke configs, or granite-3-8b / DeepSeek-V3 at their published
    widths cut to 2 layers (V3: one dense and one MoE layer)."""
    smoke = {"smoke": "granite-3-8b", "v3-smoke": "deepseek-v3-671b"}
    if name in smoke:
        return get_smoke(smoke[name])
    full = get_config({"granite-2l": "granite-3-8b",
                       "v3-2l": "deepseek-v3-671b"}[name])
    ffns = ("dense", "moe") if name == "v3-2l" else full.ffns[:2]
    return full.with_(n_layers=2, mixers=full.mixers[:2], ffns=ffns)


def _params(cfg, dtype, dev):
    return tfm.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                           device=dev, dtype=dtype)


def _tokens(rng, cfg, n, dev):
    S = n - int(rng.randint(0, BS // 2))             # the prompt, padded
    tok = np.zeros((1, n), np.int32)
    tok[0, :S] = rng.randint(1, cfg.vocab, S)
    return torch.from_numpy(tok).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-2l", "v3-2l"])
def test_replayed_prefills_are_the_eager_prefill_on_card(cuda, name):
    cfg = _config(name)
    params = _params(cfg, torch.bfloat16, cuda)
    graphs = PrefillGraphs()
    eager, graph = (state(cfg, torch.bfloat16, 1, cuda) for _ in range(2))
    rng = np.random.RandomState(5)
    calls = LENGTHS * 3
    worst = pool = 0.0
    with torch.no_grad():
        for call, n in enumerate(calls):
            if call:
                for st in (eager, graph):
                    remap(st, call)
            tok = _tokens(rng, cfg, n, cuda)
            lg_e, st_e = tfm.prefill(params, cfg, tok, dict(eager))
            lg_g, st_g = tfm.prefill(params, cfg, tok, dict(graph),
                                     graphs=graphs)
            worst = max(worst, (lg_g - lg_e).abs().max().item())
            pool = max([pool] + [
                (graph[k].float() - eager[k].float()).abs().max().item()
                for k in POOLS if k in eager])
            assert torch.equal(lg_g, lg_e), f"logits differ at call {call}"
            for k in POOLS:
                if k in eager:
                    assert torch.equal(graph[k], eager[k]), f"{k} at {call}"
            assert torch.equal(st_g["lengths"], st_e["lengths"])
    print(f"\n{name}: {len(calls)} prefills at {LENGTHS}, largest |dlogit| "
          f"{worst:.3g}, largest |dpool| {pool:.3g}")
    assert graphs.captures == len(LENGTHS) and graphs.calls == len(calls)


@pytest.mark.cuda
def test_a_pool_at_a_new_address_captures_again_on_card(cuda):
    cfg = _config("smoke")
    params = _params(cfg, torch.float32, cuda)
    graphs = PrefillGraphs()
    eager, graph = (state(cfg, torch.float32, 2, cuda) for _ in range(2))
    rng = np.random.RandomState(6)
    with torch.no_grad():
        for call in range(6):
            if call == 3:        # the pools move: another address
                for st in (eager, graph):
                    st["kv"] = st["kv"].clone()
            tok = _tokens(rng, cfg, 2 * BS, cuda)
            lg_e, _ = tfm.prefill(params, cfg, tok, dict(eager))
            lg_g, _ = tfm.prefill(params, cfg, tok, dict(graph),
                                  graphs=graphs)
            assert torch.equal(lg_g, lg_e)
            assert torch.equal(graph["kv"], eager["kv"])
            assert graphs.captures == (1 if call < 3 else 2)
    assert graphs.calls == 6


def _engine(params, cfg, dev):
    conf = EngineConfig(device=str(dev), num_blocks=48, max_batch=4,
                        max_seq_len=4 * BS, page_impl="kernel")
    return Engine(cfg, params, config=conf)


def _submit(eng, seed, n=6):
    rng = np.random.RandomState(seed)
    for i in range(n):
        eng.submit(rng.randint(1, eng.cfg.vocab, size=rng.randint(20, 300)),
                   max_new_tokens=int(rng.randint(8, 24)), stream=f"s{i}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smoke", "v3-smoke"])
def test_the_engine_counts_its_prefill_replays_on_card(cuda, name):
    """Three padded lengths captured by a first batch of requests; a
    second batch, traced, is served by replays alone."""
    cfg = _config(name)
    params = _params(cfg, torch.float32, cuda)
    runs = {}
    for graphs in (True, False):
        eng = _engine(params, cfg, cuda)
        assert isinstance(eng._prefill_graphs, PrefillGraphs)
        if not graphs:
            eng._prefill_graphs = None
        for length in (100, 200, 300):
            eng.submit(np.arange(1, length + 1) % cfg.vocab,
                       max_new_tokens=2)
        eng.run()
        eng.enable_tracing()
        _submit(eng, seed=1)
        eng.run()
        runs[graphs] = (eng, eng.metrics.snapshot(), [
            list(r.generated) for r in sorted(eng.sched.done,
                                              key=lambda r: r.rid)])
    (eng, snap, tokens), (_, off, off_tokens) = runs[True], runs[False]
    assert tokens == off_tokens
    assert eng._prefill_graphs.captures == 3
    assert snap["trace.prefill.captures"] == 0
    assert snap["trace.prefill.graph_calls"] == \
        snap["trace.launch.prefill.calls"] == 6
    assert off["trace.prefill.graph_calls"] == 0
    if "moe" in cfg.ffns:
        for key in ("trace.moe.here", "trace.moe.kept", "trace.moe.slots",
                    "trace.moe.rows"):
            assert snap[key] == off[key] > 0, key
