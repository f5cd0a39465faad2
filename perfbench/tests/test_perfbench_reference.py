"""The plain references against the port at the smoke sizes, in f32:
the port's prefill logits and its decode steps through the paged cache
equal the reference's full forward pass."""

import pytest
import torch

from perfbench import check, model
from perfbench.tests.smoke import smoke_cell

CASES = ["granite-3-8b.chat", "deepseek-v2-236b.chat"]


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_port_prefill_and_decode(name):
    from repro_torch.models import transformer as tfm
    cell, cfg = smoke_cell(name, dtype="float32")
    params = model.make_params(cfg, 5, torch.float32, "cpu")
    ref = check.reference(cell.config)
    S, steps = 45, 6
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (S + steps,), generator=g)
    want = ref.logits(params, cell.config, toks, S - 1)     # (steps+1, V)
    st = tfm.init_decode_state(cfg, 1, 256, device="cpu")
    pad = -(-S // 128) * 128
    x = torch.zeros(1, pad, dtype=torch.long)
    x[0, :S] = toks[:S]
    # prefill is padded to the block; its last row is position pad - 1,
    # so compare decode steps, which start by rewriting position S - 1
    _, st = tfm.prefill(params, cfg, x, st)
    st["lengths"] = torch.tensor([S - 1], dtype=torch.int32)
    got = []
    for j in range(steps + 1):
        lg, st = tfm.decode_step(params, cfg, st, toks[S - 1 + j:S + j],
                                 page_impl="ref")
        got.append(lg[0])
    got = torch.stack(got)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * max(1.0, float(scale))


def test_fp8_rounding_is_coarse_and_bounded():
    from perfbench.reference import fp8
    x = torch.linspace(-3, 3, 1001)
    y = fp8(x[None], -1)[0]
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 0 < rel.max() <= 2 ** -4 + 1e-6
