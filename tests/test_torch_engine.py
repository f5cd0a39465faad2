"""Engine traces through ``repro.serving.engine.Engine`` and
``repro_torch.serving.engine.Engine`` on the CPU: the same seeded
requests give identical greedy tokens, and every deterministic key of
``metrics.snapshot()`` is equal (fences, recycled hits, refreshed bytes,
admission, preemption, reshards, islands, prefix sharing, chunk and
kernel counters).  Only wall time, tokens/s, measured fence seconds and
the step-latency histogram are excluded.  The traces run the tiny
attention model, the DeepSeek-V2 smoke config (MLA + MoE, monolithic
prefill, latent pools), the DeepSeek-MoE smoke config (ragged) and the
hybrid Jamba and RWKV-6 smoke configs (per-slot recurrent states)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.configs import deepseek_moe_16b as jdsm  # noqa: E402
from repro.configs import deepseek_v2_236b as jdsv2  # noqa: E402
from repro.configs import jamba_v0_1_52b as jjamba  # noqa: E402
from repro.configs import rwkv6_7b as jrwkv  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JCfg  # noqa: E402
from repro.serving.admission import GovernorConfig as JGov  # noqa: E402
from repro.serving.config import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import deepseek_moe_16b as tdsm  # noqa: E402
from repro_torch.configs import deepseek_v2_236b as tdsv2  # noqa: E402
from repro_torch.configs import jamba_v0_1_52b as tjamba  # noqa: E402
from repro_torch.configs import rwkv6_7b as trwkv  # noqa: E402
from repro_torch.models.config import ModelConfig as TCfg  # noqa: E402
from repro_torch.serving.admission import GovernorConfig as TGov  # noqa: E402
from repro_torch.serving.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402

_CFG_KW = dict(name="trace", n_layers=1, d_model=32, n_heads=2,
               n_kv_heads=1, d_ff=64, vocab=64, head_dim=16)
_NONDETERMINISTIC = ("wall_s", "tokens_per_s", "step_latency", "measured_s")


MODELS = {"tiny": (lambda: JCfg(**_CFG_KW), lambda: TCfg(**_CFG_KW)),
          "deepseek-v2": (jdsv2.smoke, tdsv2.smoke),
          "deepseek-moe": (jdsm.smoke, tdsm.smoke),
          "jamba": (jjamba.smoke, tjamba.smoke),
          "rwkv6": (jrwkv.smoke, trwkv.smoke)}


@pytest.fixture(scope="module")
def models():
    """Model name → (JAX config, port config, JAX params, port params),
    made on first use."""
    made = {}

    def get(name):
        if name not in made:
            jcfg, tcfg = (f() for f in MODELS[name])
            jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
            made[name] = (jcfg, tcfg, jp, params_from_jax(
                jax.tree.map(np.asarray, jp), device="cpu"))
        return made[name]
    return get


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


def _replay(engine, reqs, resize=None):
    """Submit ``reqs`` and step to idle; ``resize`` maps a step count to
    the worker count :meth:`resize_workers` reshards to after it."""
    for prompt, stream, gid, mnt in reqs:
        engine.submit(prompt, max_new_tokens=mnt, stream=stream,
                      group_id=gid)
    while not engine.sched.idle and engine.steps < 10_000:
        engine.step()
        if resize and engine.steps in resize:
            engine.resize_workers(resize[engine.steps])
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
    # the worker count reshards live 1 → 4 → 2 after steps 2 and 5
    "elastic-1-4-2": dict(kw=dict(num_workers=1, scoped_fences=True,
                                  admission="fcfs", num_blocks=8),
                          trace=(11, 8), resize={2: 4, 5: 2}),
    "islands-2x2": dict(kw=dict(num_workers=4, islands=((0, 1), (2, 3)),
                                scoped_fences=True, admission="fcfs",
                                worker_routing="stream", num_blocks=8),
                        trace=(7, 8)),
    # windows over-commit a small pool: the governor preempts victims
    "preempt-recompute": dict(
        kw=dict(num_blocks=5, num_workers=2),
        governor=dict(policy="fcfs", preempt="recompute",
                      overcommit_ratio=2.0), trace=(12, 8)),
    "preempt-swap": dict(
        kw=dict(num_blocks=5, num_workers=2),
        governor=dict(policy="fcfs", preempt="swap", overcommit_ratio=2.0),
        trace=(12, 8)),
    "deepseek-v2": dict(model="deepseek-v2", kw=dict(fpr_enabled=True),
                        trace=(1, 12)),
    # shared prompt prefixes: COW copies the latent pools' rows
    "deepseek-v2-prefix": dict(model="deepseek-v2",
                               kw=dict(prefix_sharing=True,
                                       admission="fcfs"),
                               trace=(5, 6, 128)),
    "deepseek-v2-elastic": dict(
        model="deepseek-v2", kw=dict(num_workers=1, scoped_fences=True,
                                     admission="fcfs", num_blocks=8),
        trace=(11, 8), resize={2: 4, 5: 2}),
    # the latent pools round-trip through the swap store
    "deepseek-v2-swap": dict(
        model="deepseek-v2", kw=dict(num_blocks=5, num_workers=2),
        governor=dict(policy="fcfs", preempt="swap", overcommit_ratio=2.0),
        trace=(12, 8)),
    "deepseek-moe-ragged": dict(
        model="deepseek-moe", kw=dict(chunked_prefill=True, prefill_chunk=1,
                                      ragged_kernel=True, admission="fcfs"),
        trace=(4, 7)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_trace_matches_reference(models, name):
    case = CASES[name]
    jcfg, tcfg, jp, tp = models(case.get("model", "tiny"))
    common = {"num_blocks": 64, "max_batch": 4, "max_seq_len": 512,
              **case["kw"]}
    gov = case.get("governor")
    reqs = _trace(*case["trace"])
    resize = case.get("resize")
    want_toks, want = _replay(
        JEngine(jcfg, jp, config=JConfig(
            page_impl="ref", **common,
            **({"admission": JGov(**gov)} if gov else {}))), reqs, resize)
    got_toks, got = _replay(
        TEngine(tcfg, tp, config=TConfig(
            device="cpu", **common,
            **({"admission": TGov(**gov)} if gov else {}))), reqs, resize)
    assert got_toks == want_toks
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if want[k] != v} == {}
    if gov:
        assert got[f"admission.preemptions_{gov['preempt']}"] > 0
    if gov and gov["preempt"] == "swap":
        assert got["fpr.swap_ins"] > 0
    if resize:
        assert got["device.reshards"] == len(resize)
        assert got["engine.num_workers"] == resize[max(resize)]
    if "islands" in case["kw"]:
        assert got["fence.island.fences_cross"] + \
            got["fence.island.fences_intra"] > 0
    if name == "prefix":
        assert got["fpr.prefix.hit_blocks"] > 0
    if name in ("ragged", "deepseek-moe-ragged"):
        assert got["engine.prefill_chunk_traces"] == 1
        assert got["engine.kernel.kernel_calls"] == \
            tcfg.n_layers * got["engine.kernel.ragged_steps"]
    if name in ("fpr", "deepseek-v2"):
        assert got["fpr.recycled_hits"] > 0 and got["fence.skipped_at_free"]
    if name.startswith("deepseek-v2"):
        assert got["engine.prefill_traces"] >= 2   # one per padded length
    if name == "deepseek-v2-prefix":
        assert got["fpr.prefix.hit_blocks"] > 0 and got["fpr.prefix.cow_copies"]


@pytest.mark.parametrize("name", ["jamba", "rwkv6"])
def test_hybrid_engine_trace_matches_reference(models, name):
    """Jamba (Mamba + attention + MoE) and RWKV-6 served with fpr on: the
    recurrent states live per batch slot, prefill writes them through a
    batch-1 view of the request's slot, and decode steps them for every
    slot; tokens and counters equal the reference engine's."""
    jcfg, tcfg, jp, tp = models(name)
    common = {"num_blocks": 64, "max_batch": 4, "max_seq_len": 512,
              "fpr_enabled": True}
    reqs = _trace(1, 10)
    want_toks, want = _replay(JEngine(jcfg, jp, config=JConfig(
        page_impl="ref", **common)), reqs)
    eng = TEngine(tcfg, tp, config=TConfig(device="cpu", **common))
    got_toks, got = _replay(eng, reqs)
    assert got_toks == want_toks
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if want[k] != v} == {}
    assert got["fpr.recycled_hits"] > 0
    keys = {"jamba": ("conv", "ssm"), "rwkv6": ("rwkv_x", "rwkv_s")}[name]
    assert eng._slot_state_keys == list(keys)
    for k in keys:                       # every slot served a request
        assert all(eng.cache.state[k][:, s].abs().sum() > 0
                   for s in range(common["max_batch"]))


def test_engine_config_defaults_and_checks():
    cfg = TConfig()
    assert (cfg.device, cfg.dtype, cfg.page_impl) == ("cuda", torch.float32,
                                                      "kernel")
    with pytest.raises(ValueError):
        TConfig(page_impl="pallas")
    with pytest.raises(ValueError):
        TConfig(ragged_kernel=True, chunked_prefill=False)
