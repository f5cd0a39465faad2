"""The output check at the smoke sizes (weights and pool in f32, so the
program's gap is rounding and the limit 1e-3): the program passes; the
fp8 control, put in its place, fails; and a run whose timed path is
broken underneath comes out not correct, for each fault a one-chip
serving cell can have.  (No cell spans chips, so the exchange between
chips has no fault to plant.)

The port's MoE drops the slots past each expert's capacity, which the
reference (like the published model) does not; at the smoke size (8
experts) those drops alone move logits by 2e-2, so these tests give the
port's MoE room for every slot (``capacity_for``) to hold the rest of
the path to f32 rounding."""

import itertools

import pytest
import torch

from perfbench.harness import run_cell
from perfbench.tests.smoke import ROOT, smoke_cell

import json

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
LIMIT = 1e-3
POOLS = ("kv", "mla_c", "mla_rope")


@pytest.fixture(autouse=True)
def dropless(monkeypatch):
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "capacity_for",
                        lambda tokens, top_k, experts, *a, **k:
                        tokens * top_k)


@pytest.mark.parametrize("seed", [2**31 + 5, 2**31 + 6])
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_the_fp8_control_fails(name, seed):
    cell, cfg = smoke_cell(name, limit=LIMIT, dtype="float32")
    out = run_cell(cell, seed, 2.0, False, "cpu", cfg=cfg, control=True)
    (key, c), = out["checks"].items()
    gap, ctrl = c["value"], out["control"][key]
    assert out["checked"]["requests"] > 0
    assert out["correct"] and gap <= LIMIT
    assert ctrl > LIMIT and ctrl >= 3 * gap


def _state_unchanged(fn):
    """The step writes nothing to the pools."""
    def call(*a, **k):
        state = a[2] if len(a) > 2 and isinstance(a[2], dict) else a[3]
        saved = {key: state[key].clone() for key in POOLS if key in state}
        out = fn(*a, **k)
        for key, v in saved.items():
            state[key].copy_(v)
        return out
    return call


def _half_batch(fn):
    """The second half of the slots gets the first half's answers."""
    def call(*a, **k):
        logits, st = fn(*a, **k)
        B = logits.shape[0]
        logits = logits.clone()
        logits[B // 2:] = logits[:B - B // 2]
        return logits, st
    return call


def _token_altered(fn):
    """One slot's token, a different slot each call, is moved off the
    best logit where it is produced."""
    count = itertools.count()

    def call(*a, **k):
        logits, st = fn(*a, **k)
        logits = logits.clone()
        b = next(count) % logits.shape[0]
        logits[b] = torch.roll(logits[b], 1, dims=-1)
        return logits, st
    return call


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from repro_torch.models import transformer as tfm
    for entry in ("decode_step", "ragged_step"):
        monkeypatch.setattr(tfm, entry, FAULTS[fault](getattr(tfm, entry)))
    cell, cfg = smoke_cell(name, limit=LIMIT, dtype="float32")
    out = run_cell(cell, 2**31 + 9, 2.0, False, "cpu", cfg=cfg)
    assert out["checked"]["requests"] > 0
    assert out["correct"] is False
    (c,) = out["checks"].values()
    assert c["value"] > LIMIT
