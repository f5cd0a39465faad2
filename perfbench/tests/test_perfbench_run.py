"""Each cell end to end on the CPU at its configuration's smoke size,
up to the last line ``run.py`` prints; ``run.py`` itself refuses a
machine without CUDA."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import spec
from perfbench.harness import run_cell
from perfbench.tests.smoke import ROOT, run_module, smoke_cell

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 77


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_cell_end_to_end_on_cpu(name, trace):
    cell, cfg = smoke_cell(name)
    out = run_cell(cell, SEED, 2.5, trace, "cpu", cfg=cfg)
    line = run_module().result_line(out, cell.chips, "cpu", "n/a")
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    json.dumps(line)
    want = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    assert set(line["metrics"]) <= set(want)
    if not trace:
        assert set(line["metrics"]) == set(want)
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(c["value"] <= 1.0 for c in line["checks"].values())
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0


def test_run_refuses_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_fails_in_a_folder_of_the_benchmark_alone(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_every_cell_loads():
    for name in CELLS:
        cell = spec.load(name)
        assert cell.end_to_end and cell.per_layer
