"""On the card: DeepSeek-V3's published widths cut to one dense and one
MoE layer (the router over 256 experts, 32 held, the shared expert), in
bf16 weights and latent pools, served by the engine (monolithic prefill,
then decode steps at batch 64 over the MLA kernel) and held to the plain
f32 reference (``perfbench/reference/deepseek_v3.py``) at every decoded
position.  The comparison is of logits: each position's largest
|Δlogit| against the reference, averaged over the positions, has to stay
below the fp8 control's (the reference with every weight product in
float8 e4m3, the precision below bf16), read at the same positions; the
largest over the positions is printed beside it.  Skips without a CUDA
device; on a machine with one run it with ``python -m pytest -q -s -m
cuda tests/test_torch_deepseek_v3_cuda.py`` (the file imports no JAX)."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

BATCH, STEPS = 64, 32


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import _build
    _build.build_all()
    return torch.device("cuda")


def _file_config(cfg) -> dict:
    """The configuration file's keys, at ``cfg``'s depth."""
    import json
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / "deepseek-v3-671b.json").read_text())
    return {**conf, "num_hidden_layers": cfg.n_layers,
            "first_k_dense_replace": cfg.ffns.index("moe")}


@pytest.mark.cuda
def test_two_published_layers_in_bf16_match_the_f32_reference_on_card(
        cuda, monkeypatch):
    from perfbench import model
    from perfbench.reference import deepseek_v3 as ref
    full = get_config("deepseek-v3-671b")
    cfg = full.with_(n_layers=2, mixers=full.mixers[:2],
                     ffns=("dense", "moe"))
    params = model.make_params(cfg, 2147483901, torch.bfloat16, cuda)
    # a seeded nonzero correction bias (the benchmark's runs draw it zero)
    ffn = tfm.layer_params(params, cfg, 1)["ffn"]
    ffn["router_bias"].copy_(0.05 * torch.randn(
        cfg.moe.routed_experts, device=cuda,
        generator=torch.Generator(cuda).manual_seed(3)))
    eng = Engine(cfg, params, config=EngineConfig(
        max_batch=BATCH, max_seq_len=512, num_blocks=BATCH * 4,
        dtype=torch.bfloat16, device="cuda", page_impl="kernel"))
    rng = np.random.default_rng(5)
    lens = rng.integers(64, 300, size=BATCH)
    for i, n in enumerate(lens):
        eng.submit(rng.integers(0, cfg.vocab, size=int(n)),
                   max_new_tokens=STEPS, stream=f"s{i}", group_id=i + 1)

    rows: dict = {}                 # (rid, j) -> the decode step's logits
    inner = tfm.decode_step

    def spy(*a, **k):
        who = {s: (r.rid, len(r.generated))
               for s, r in eng.sched.running.items() if r.state == "running"}
        logits, st = inner(*a, **k)
        for s, key in who.items():
            rows[key] = logits[s].float().cpu()
        return logits, st
    monkeypatch.setattr(tfm, "decode_step", spy)
    eng.run()
    done = sorted(eng.sched.done, key=lambda r: r.rid)
    assert len(done) == BATCH and all(len(r.generated) == STEPS for r in done)
    assert eng.decode_steps >= STEPS

    conf = _file_config(cfg)
    worst = ctrl_worst = 0.0
    per, per_ctrl = [], []
    for r in done:
        seq = torch.as_tensor(np.concatenate(
            [np.asarray(r.prompt), np.asarray(r.generated[:-1])]),
            device=cuda)
        first = len(r.prompt) - 1
        want = ref.logits(params, conf, seq, first).cpu()
        low = ref.logits(params, conf, seq, first, quant="fp8").cpu()
        got = torch.stack([rows[(r.rid, j)] for j in range(STEPS)])
        d = (got - want).abs().amax(-1)
        c = (low - want).abs().amax(-1)
        per.append(d)
        per_ctrl.append(c)
        worst, ctrl_worst = max(worst, float(d.max())), max(ctrl_worst,
                                                             float(c.max()))
    per, per_ctrl = torch.cat(per), torch.cat(per_ctrl)
    print(f"\ndeepseek-v3 2 layers bf16, {BATCH} x {STEPS} decoded positions: "
          f"largest |dlogit| {worst:.5f} (mean of each position's largest "
          f"{float(per.mean()):.5f}); fp8 control {ctrl_worst:.5f} "
          f"({float(per_ctrl.mean()):.5f})")
    assert float(per.mean()) < float(per_ctrl.mean())
