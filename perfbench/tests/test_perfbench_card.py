"""On the card: one short run of every cell through ``run.py``, and the
trace's reading on one.  ``python -m pytest -q -m cuda perfbench/tests``
on a machine with an H100; elsewhere they skip."""

import json
import subprocess
import sys

import pytest

from perfbench.tests.smoke import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(name, trace):
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         str(2**31 + 99), "--seconds", "5", "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_card(name):
    _card()
    line = _run(name, 0)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.cuda
def test_traced_run_reads_the_device_on_card():
    _card()
    line = _run(CELLS[-1], 1)
    dev = line["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert line["breakdown"]["device_ops"]
    assert "device_idle_pct" in line["metrics"]
