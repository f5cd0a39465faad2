"""DeepSeek-V3 as one chip of an 8-way expert-parallel layer
(``configs/deepseek_v3_671b.py``), on the CPU against the plain reference
``tests/_plain_deepseek_v3.py``, which imports neither JAX nor the port:

* the router (``models/moe._route_grouped``) against a line-for-line
  transcription of DeepSeek-V3's ``Gate``, at the smoke size and at the
  published 256 experts in 8 groups, top-4 groups, top-8, with a seeded
  nonzero correction bias, and with a bias that moves the winning group;
* the held share: the eight chips' outputs of one MoE layer, the shared
  expert counted once, add up to the whole dropless layer;
* ``prefill`` then ``decode_step`` through the MLA cache against the
  plain reference's full forward pass, in f32, tight enough that bf16
  weights fail it;
* the benchmark's copy of the reference (``perfbench/reference/
  deepseek_v3.py``) against the plain one, the configuration file against
  the port's config (``perfbench/model.check_config``), the parameter
  accounting, the registration, the recorder's counters and span, and
  the benchmark's two readers of them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import _plain_deepseek_v3 as plain  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.moe_config import GroupRoutedMoE  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

ARCH = "deepseek-v3-671b"
CELL = "deepseek-v3-671b.ep8-chat"


def _spec(cfg, first: int = 0) -> dict:
    """The configuration file's keys at ``cfg``'s sizes (the plain
    reference's ``spec``)."""
    m, mo = cfg.mla, cfg.moe
    return {"num_attention_heads": cfg.n_heads, "rms_norm_eps": cfg.norm_eps,
            "qk_nope_head_dim": m.nope_head_dim,
            "qk_rope_head_dim": m.rope_head_dim, "v_head_dim": m.v_head_dim,
            "kv_lora_rank": m.kv_lora_rank,
            "rope_theta": cfg.attn.rope_theta,
            "first_k_dense_replace": cfg.ffns.index("moe"),
            "n_group": mo.expert_groups, "topk_group": mo.top_expert_groups,
            "num_experts_per_tok": mo.top_k,
            "routed_scaling_factor": mo.routed_scale,
            "n_routed_experts": mo.num_experts,
            "deployment": {"held_first_expert": first}}


def _params(cfg, seed: int = 0, bias: float = 0.05) -> dict:
    """Seeded f32 params with a nonzero seeded correction bias."""
    gen = torch.Generator().manual_seed(seed)
    params = tfm.init_params(cfg, generator=gen, device="cpu",
                             dtype=torch.float32)
    g = torch.Generator().manual_seed(seed + 1)
    for lp in plain.layer_list(params):
        if "router_bias" in lp["ffn"]:
            lp["ffn"]["router_bias"].copy_(
                bias * torch.randn(cfg.moe.routed_experts, generator=g))
    return params


# ------------------------------------------------------------------ router
ROUTERS = {"smoke": (32, 8, 4, 8), "published": (256, 8, 4, 8)}


def _moe_config(routed, groups, top_groups, k, held=None, first=0):
    return GroupRoutedMoE(num_experts=held or routed, top_k=k, num_shared=1,
                          d_expert=16, routed_experts=routed,
                          expert_groups=groups, top_expert_groups=top_groups,
                          routed_scale=2.5, held_first=first)


@pytest.mark.parametrize("size", sorted(ROUTERS))
def test_router_matches_the_gate_transcription(size):
    R, G, kg, k = ROUTERS[size]
    mo = _moe_config(R, G, kg, k)
    g = torch.Generator().manual_seed(7)
    D, T = 64, 96
    x = torch.randn(T, D, generator=g)
    router = torch.randn(D, R, generator=g) / D ** 0.5
    bias = 0.1 * torch.randn(R, generator=g)
    gates, eidx, aux = moe_mod._route_grouped(router, bias, x, mo)
    want_w, want_i = plain.gate(x, router, bias, G, kg, k, 2.5)
    assert torch.equal(eidx, want_i)
    torch.testing.assert_close(gates, want_w, rtol=1e-6, atol=1e-7)
    assert float(aux) == 0.0
    # the gates sum to the routed scale, and every token's experts lie in
    # at most top_expert_groups groups
    torch.testing.assert_close(gates.sum(-1), torch.full((T,), 2.5))
    assert int((eidx // (R // G)).sort(-1).values.diff(dim=-1).ne(0)
               .sum(-1).max()) + 1 <= kg


@pytest.mark.parametrize("size", sorted(ROUTERS))
def test_the_bias_moves_the_winning_group(size):
    """A bias on a group no token picks makes every token pick it; the
    gates stay the uncorrected scores'."""
    R, G, kg, k = ROUTERS[size]
    mo = _moe_config(R, G, kg, k)
    g = torch.Generator().manual_seed(11)
    D, T = 64, 32
    x = torch.randn(T, D, generator=g)
    router = torch.randn(D, R, generator=g) / D ** 0.5
    zero = torch.zeros(R)
    _, before, _ = moe_mod._route_grouped(router, zero, x, mo)
    picked = set((before[0] // (R // G)).tolist())
    lost = next(i for i in range(G) if i not in picked)
    bias = torch.zeros(R)
    bias[lost * (R // G):(lost + 1) * (R // G)] = 1.0
    gates, eidx, _ = moe_mod._route_grouped(router, bias, x, mo)
    want_w, want_i = plain.gate(x, router, bias, G, kg, k, 2.5)
    assert torch.equal(eidx, want_i)
    torch.testing.assert_close(gates, want_w, rtol=1e-6, atol=1e-7)
    assert ((eidx[0] // (R // G)) == lost).any()
    assert not torch.equal(eidx, before)
    s = torch.sigmoid(x @ router)
    torch.testing.assert_close(
        gates, 2.5 * s.gather(1, eidx) / s.gather(1, eidx).sum(-1, True))


# -------------------------------------------------------------- held share
def test_eight_held_shares_sum_to_the_whole_layer():
    """Each of the 8 chips holds one group of 4 of the 32 experts; their
    dropless outputs, the shared expert counted once, are the whole
    layer's, which is the plain reference's."""
    smoke = configs.get_smoke(ARCH)
    whole = smoke.with_(moe=dataclasses.replace(smoke.moe, num_experts=32))
    params = _params(whole, seed=3, bias=0.2)
    f = plain.layer_list(params)[-1]["ffn"]
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 24, smoke.d_model, generator=g)
    # capacity above any load: every slot kept
    big = float(whole.moe.routed_experts)
    want, _ = moe_mod.moe_mix(f, x, whole, capacity_factor=big)
    h = x.reshape(-1, smoke.d_model)
    shared = plain.swiglu(h, f["s_gate"], f["s_up"], f["s_down"])
    total = torch.zeros_like(h)
    for i in range(8):
        cfg = smoke.with_(moe=dataclasses.replace(smoke.moe,
                                                  held_first=4 * i))
        part = {**f, **{w: f[w][4 * i:4 * (i + 1)]
                        for w in ("w_gate", "w_up", "w_down")}}
        out, _ = moe_mod.moe_mix(part, x, cfg, capacity_factor=big)
        total += out.reshape(-1, smoke.d_model) - shared
    torch.testing.assert_close(total + shared,
                               want.reshape(-1, smoke.d_model),
                               rtol=1e-5, atol=1e-6)
    # the whole layer against the plain reference's MoE block (which adds
    # the residual and norms itself)
    ref = plain.moe(f, h, _spec(whole), 0) - h
    normed = moe_mod.rms_norm(x, f["norm"], whole.norm_eps)
    got, _ = moe_mod.moe_mix(f, normed, whole, capacity_factor=big)
    torch.testing.assert_close(got.reshape(-1, smoke.d_model), ref,
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ engine
#: real prompt tokens: under the prefill's capacity (44 a held expert for
#: its 128 padded rows) even if every one chose the same expert, and real
#: rows sort before the padding, so no real slot is dropped; a decode
#: step routes one token (at most one slot an expert, capacity 4)
PROMPT, STEPS = 40, 8
#: |Δlogit| ≤ TOL × max(1, max |logit|): f32 products in two orders (the
#: absorbed decode against the expanded reference) differ by ~1e-6 of
#: the scale; bf16 weights miss it by two orders of magnitude
TOL = 1e-4


def _serve(cfg, params, toks, page_impl, dtype):
    st = tfm.init_decode_state(cfg, 1, 256, dtype=dtype, device="cpu")
    x = torch.zeros(1, 128, dtype=torch.long)
    x[0, :PROMPT] = toks[:PROMPT]
    _, st = tfm.prefill(params, cfg, x, st)
    # the prefill is padded to the block: decode rewrites position
    # PROMPT - 1 and goes on from there
    st["lengths"] = torch.tensor([PROMPT - 1], dtype=torch.int32)
    out = []
    for j in range(STEPS + 1):
        lg, st = tfm.decode_step(params, cfg, st,
                                 toks[PROMPT - 1 + j:PROMPT + j],
                                 page_impl=page_impl)
        out.append(lg[0].float())
    return torch.stack(out)


@pytest.fixture(scope="module")
def served():
    cfg = configs.get_smoke(ARCH).with_(
        moe=dataclasses.replace(configs.get_smoke(ARCH).moe, held_first=8))
    params = _params(cfg, seed=1, bias=0.1)
    toks = torch.randint(0, cfg.vocab, (PROMPT + STEPS,),
                         generator=torch.Generator().manual_seed(2))
    want = plain.logits(params, _spec(cfg, first=8), toks)[PROMPT - 1:]
    return cfg, params, toks, want


@pytest.mark.parametrize("page_impl", ["ref", "kernel"])
def test_prefill_and_decode_match_the_plain_reference(served, page_impl):
    cfg, params, toks, want = served
    got = _serve(cfg, params, toks, page_impl, torch.float32)
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err


def test_bf16_weights_fail_the_tolerance(served):
    """The comparison can tell the configuration's precision from the
    one below it: bf16 weights and pool miss the f32 tolerance."""
    cfg, params, toks, _ = served
    low = tfm.init_params(cfg, generator=None, device="meta",
                          dtype=torch.bfloat16)

    def cast(p, m):
        if isinstance(p, torch.Tensor):
            return p.to(m.dtype)
        if isinstance(p, dict):
            return {k: cast(p[k], m[k]) for k in p}
        return [cast(a, b) for a, b in zip(p, m)]
    low = cast(params, low)
    want = plain.logits(low, _spec(cfg, first=8), toks)[PROMPT - 1:]
    got = _serve(cfg, low, toks, "ref", torch.bfloat16)
    err = float((got - want).abs().max())
    assert err > TOL * max(1.0, float(want.abs().max())), err


# --------------------------------------------------------------- benchmark
def test_benchmark_reference_equals_the_plain_one():
    from perfbench.reference import deepseek_v3
    cfg = configs.get_smoke(ARCH).with_(
        moe=dataclasses.replace(configs.get_smoke(ARCH).moe, held_first=20))
    params = _params(cfg, seed=4, bias=0.3)
    toks = torch.randint(0, cfg.vocab, (70,),
                         generator=torch.Generator().manual_seed(9))
    spec = _spec(cfg, first=20)
    want = plain.logits(params, spec, toks)[30:]
    got = deepseek_v3.logits(params, spec, toks, 30)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_configuration_file_matches_the_port():
    from perfbench import model, spec
    from perfbench.tests.smoke import smoke_cell
    cell, cfg = smoke_cell(CELL)
    assert cfg == configs.get_smoke(ARCH)
    full = spec.load(CELL, ROOT).config
    cut = model.port_config(full)          # raises where a width departs
    assert cut.n_layers == 11 and cut.ffns.count("moe") == 8
    assert full["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert full["published"] == {"num_hidden_layers": 61,
                                 "n_routed_experts": 256}
    mo = cut.moe
    assert (mo.routed_experts, mo.expert_groups, mo.top_expert_groups,
            mo.routed_scale, mo.held_first) == (
        full["published"]["n_routed_experts"], full["n_group"],
        full["topk_group"], full["routed_scaling_factor"],
        full["deployment"]["held_first_expert"])
    assert full["scoring_func"] == "sigmoid" and full["norm_topk_prob"]
    assert full["topk_method"] == "noaux_tc"
    # the file's routing counts hold at the smoke size
    smo = cfg.moe
    assert (smo.expert_groups, smo.top_expert_groups, smo.top_k,
            smo.routed_scale) == (full["n_group"], full["topk_group"],
                                  full["num_experts_per_tok"],
                                  full["routed_scaling_factor"])


# ------------------------------------------------------- config accounting
@pytest.mark.parametrize("which", ["full", "cell", "smoke"])
def test_param_accounting(which):
    """``param_count`` against ``init_params`` on the meta device: the
    router is 256 wide, the bias is counted, the stacks hold 32."""
    cfg = configs.get_config(ARCH)
    if which == "cell":
        cfg = cfg.with_(n_layers=11, mixers=cfg.mixers[:11],
                        ffns=cfg.ffns[:11])
    elif which == "smoke":
        cfg = configs.get_smoke(ARCH)
    params = tfm.init_params(cfg, generator=None, device="meta",
                             dtype=torch.bfloat16)
    assert tfm.param_count(params) == cfg.param_count()
    f = plain.layer_list(params)[-1]["ffn"]
    mo = cfg.moe
    assert f["router"].shape == (cfg.d_model, mo.routed_experts)
    assert f["router_bias"].shape == (mo.routed_experts,)
    assert f["router"].dtype == f["router_bias"].dtype == torch.float32
    assert f["w_gate"].shape[0] == mo.num_experts
    if which == "cell":
        assert abs(cfg.param_count() - 16.742e9) < 1e6
    # a token uses top_k / routed_experts of the stacks held here
    stack = sum(f[w].numel() for w in ("w_gate", "w_up", "w_down"))
    active = cfg.param_count() - cfg.active_param_count()
    assert active == cfg.ffns.count("moe") * (
        stack - 3 * int(stack / 3 * mo.top_k / mo.routed_experts))


def test_registered_outside_the_reference_paired_ids():
    assert ARCH not in configs.ARCH_IDS
    assert configs.get_config(ARCH).moe.num_experts == 32
    assert configs.get_smoke(ARCH).moe.routed_experts == 32
    with pytest.raises(ValueError):
        GroupRoutedMoE(num_experts=40, top_k=8, routed_experts=256,
                       expert_groups=8, top_expert_groups=4, held_first=224)


# --------------------------------------------------------------- recorder
def _engine(arch):
    cfg = configs.get_smoke(arch)
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32)
    eng = Engine(cfg, params, config=EngineConfig(
        max_batch=4, max_seq_len=256, num_blocks=16, device="cpu"))
    return cfg, eng


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-236b"])
def test_recorder_counts_held_slots_and_times_the_router(arch):
    cfg, eng = _engine(arch)
    rec = eng.enable_tracing()
    g = torch.Generator().manual_seed(4)
    for i in range(3):
        eng.submit(torch.randint(0, cfg.vocab, (30 + 11 * i,),
                                 generator=g).tolist(), max_new_tokens=6,
                   stream=f"s{i}", group_id=i + 1)
    snap = eng.run()
    slots, here = snap["trace.moe.slots"], snap["trace.moe.here"]
    assert snap["trace.moe.kept"] <= here <= slots and slots > 0
    if arch == ARCH:
        assert 0 < here < slots       # 4 of 32 experts held
    else:
        assert here == slots          # every expert held
    assert snap["trace.moe.route_s"] > 0
    routes = [s for s in rec.spans if s.name == "model.moe.route"]
    moes = {s.id: s for s in rec.spans if s.name == "model.moe"}
    assert routes and len(routes) == len(moes)
    assert all(s.parent in moes for s in routes)
    assert abs(sum(s.t1 - s.t0 for s in routes) / 1e9
               - snap["trace.moe.route_s"]) < 1e-9


class _Window:
    def __init__(self, c0, c1):
        self.counters0, self.counters1 = c0, c1

    def counter(self, key):
        return self.counters1.get(key, 0) - self.counters0.get(key, 0)


def _reader(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,c0,c1,want", [
    ("route_ms_per_step", {"trace.moe.route_s": 1.0, "trace.engine.steps": 10},
     {"trace.moe.route_s": 1.5, "trace.engine.steps": 110}, 5.0),
    ("route_ms_per_step", {}, {"trace.engine.steps": 100}, None),
    ("moe_here_pct", {"trace.moe.here": 10, "trace.moe.slots": 100},
     {"trace.moe.here": 60, "trace.moe.slots": 500}, 12.5),
    ("moe_here_pct", {}, {"trace.moe.slots": 100}, None)],
    ids=["route", "route-absent", "here", "here-absent"])
def test_readers(name, c0, c1, want):
    got = _reader(name).read(_Window(c0, c1))
    assert got == pytest.approx(want) if want is not None else got is None
