"""On the card: every kernel of the port reaches the profiler's trace under
its own name, and the span recorder (``core/recorder.py``) times the
engine's launches with CUDA events and shares the profiler's clock.
These skip without a CUDA device; on a machine with one run them with
``python -m pytest -q -m cuda tests/test_torch_tracing_cuda.py`` (the
file imports no JAX)."""

from __future__ import annotations

import json
import re
import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as tfops  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as tmsops  # noqa: E402
from repro_torch.kernels.mla_attention import mla_attention as tmk  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as tpa  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as trkops  # noqa: E402
from _torch_cases import (FLASH, MAMBA, MLA, PAGED, RAGGED,  # noqa: E402
                          flash_case, mamba_case, mla_case, paged_case,
                          ragged_case, rwkv6_case, RWKV6)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # every library built before the first profiler session, as a
    # benchmark run builds them: on the card, a library built after
    # earlier sessions of the same process had kernels missing from the
    # later sessions' traces
    from repro_torch.kernels import _build
    _build.build_all()
    return torch.device("cuda")


def t(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _paged(dev):
    c = paged_case(10, **PAGED[0])
    B, H, hd = c["q"].shape
    KV = c["kv"].shape[2] // 2
    q = t(c["q"], dev).reshape(B, KV, H // KV, hd)
    args = (q, t(c["kv"], dev), t(c["stack"], dev), t(c["lengths"], dev))
    return lambda: tpa.paged_attention_fused_fwd(*args, window=c["window"])


def _ragged(dev):
    c = ragged_case(11, **RAGGED[0])
    d = c["d"]
    args = [t(c["q"], dev), t(c["kv"], dev), t(c["stack"], dev),
            t(d["tile_row"], dev), t(d["tile_pos"], dev),
            t(d["kv_lens"], dev)]
    return lambda: tops.ragged_paged_attention(*args, window=c["window"])


def _mla(dev):
    c = mla_case(12, **MLA[0])
    args = [t(c[k], dev) for k in ("q_lat", "q_rope", "c", "kr", "stack",
                                   "lengths")]
    return lambda: tmk.mla_paged_ctx_fwd(*args, scale=c["scale"])


def _flash(dev):
    c = flash_case(15, **FLASH[0])
    args = [t(c[k], dev) for k in ("q", "k", "v")]
    return lambda: tfops.flash_attention(
        *args, causal=c["causal"], window=c["window"],
        q_offset=c["q_offset"])


def _mamba(dev):
    c = mamba_case(13, **MAMBA[0])
    args = [t(c[k], dev) for k in ("dt", "A", "B", "C", "x", "h0")]
    return lambda: tmsops.mamba_scan(*args, chunk=c["chunk"])


def _rwkv6(dev):
    c = rwkv6_case(14, **RWKV6[0])
    args = [t(c[k], dev) for k in ("r", "k", "v", "w", "u", "S0")]
    return lambda: trkops.rwkv6_scan(*args, chunk=c["chunk"])


#: wrapper -> (its inputs, the kernels one call launches)
WRAPPERS = {
    "paged_decode": (_paged, {"paged_decode_kernel"}),
    "ragged": (_ragged, {"ragged_plan_kernel", "ragged_kernel"}),
    "mla": (_mla, {"mla_ctx_kernel"}),
    "flash": (_flash, {"flash_fwd_kernel"}),
    "mamba_scan": (_mamba, {"mamba_scan_kernel"}),
    "rwkv6_scan": (_rwkv6, {"rwkv6_scan_kernel"}),
}


def _profiled(fn, tmp_path):
    """The profiler's Chrome trace of one ``fn()`` on the card."""
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    return json.loads(path.read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_each_kernel_reaches_the_trace_under_its_own_name_on_card(
        cuda, wrapper, tmp_path):
    make, names = WRAPPERS[wrapper]
    fn = make(cuda)
    fn()                                  # built and loaded before tracing
    torch.cuda.synchronize()
    ops = [e["name"] for e in _profiled(fn, tmp_path)["traceEvents"]
           if e.get("cat") == "kernel"]
    # the demangled signature without its return type starts with the
    # kernel's qualified name, not with "(anonymous namespace)"
    heads = {re.sub(r"^void\s+", "", n).split("<")[0].split("(")[0]
             for n in ops}
    assert "" not in heads and not any("anonymous" in n for n in ops)
    assert {h.rsplit("::", 1)[-1] for h in heads} >= names, ops


TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=128, head_dim=16)


def _serve(eng, n=4):
    rng = np.random.RandomState(0)
    for i in range(n):
        eng.submit(rng.randint(1, 128, size=rng.randint(40, 200)),
                   max_new_tokens=6, stream=f"s{i}", group_id=i + 1)
    eng.run()


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True], ids=["decode", "ragged"])
def test_recorder_times_launches_and_shares_the_profilers_clock_on_card(
        cuda, ragged, tmp_path):
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Engine
    cfg = ModelConfig(**TINY)
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda, dtype=torch.float32)
    kw = dict(chunked_prefill=True, prefill_chunk=1, ragged_kernel=True) \
        if ragged else {}
    eng = Engine(cfg, params, config=EngineConfig(
        device="cuda", page_impl="kernel", num_blocks=24, max_batch=4,
        max_seq_len=512, **kw))
    _serve(eng)                           # every shape once, untraced
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA]) as p:
        _serve(eng)
        torch.cuda.synchronize()
    rec = eng._rec
    assert rec is not None
    launches = [s for s in rec.spans if s.name == "engine.launch"]
    assert launches and all(s.device_ms() > 0 for s in launches)
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    theirs = sorted(e["ts"] + base / 1e3 for e in trace["traceEvents"]
                    if e.get("cat") == "user_annotation"
                    and e["name"] == "engine.step")
    mine = sorted(rec.profiler_us(s.t0) + rec.base_ns / 1e3
                  for s in rec.spans if s.name == "engine.step")
    assert len(theirs) == len(mine)
    diffs = [abs(a - b) for a, b in zip(theirs, mine)]
    print(f"engine.step starts, recorder vs profiler (us): median "
          f"{statistics.median(diffs):.1f}, max {max(diffs):.1f}, "
          f"n {len(diffs)}")
    assert statistics.median(diffs) < 100.0
