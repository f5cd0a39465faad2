"""A cell, a traffic mix and a per-layer metric added as files to a copy
of the benchmark are picked up by name, with no file that is there
edited."""

import hashlib
import json
import shutil
import sys

from perfbench import spec
from perfbench.tests.smoke import ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_files_are_picked_up(tmp_path):
    root = tmp_path / "copy"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "granite-3-8b.tiny-chat", "config": "granite-3-8b",
        "traffic": "tiny-chat", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "steps_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "tokens_per_s",
        "workloads": ["granite-3-8b.tiny-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = root / "perfbench"
    (pkg / "traffic" / "tiny-chat.json").write_text(json.dumps({
        "clients": 2, "sizes": 8,
        "prompt": {"median": 40, "sigma": 0.3, "min": 20, "max": 90},
        "output": {"median": 4, "sigma": 0.2, "min": 3, "max": 6}}))
    (pkg / "workloads" / "granite-3-8b.tiny-chat.json").write_text(
        (pkg / "workloads" / "granite-3-8b.chat.json").read_text())
    (pkg / "metrics" / "steps_per_s.py").write_text(
        "def read(rec):\n    return rec.steps / rec.window_s\n")

    cell = spec.load("granite-3-8b.tiny-chat", root)
    assert cell.traffic["clients"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "steps_per_s"
    # the copy's metric module, imported from the copy's package
    saved = {k: v for k, v in sys.modules.items()
             if k == "perfbench" or k.startswith("perfbench.")}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        from perfbench import harness as copy_harness
        from perfbench.tests.smoke import smoke_cell as copy_smoke
        small, cfg = copy_smoke("granite-3-8b.tiny-chat", root=root)
        small.traffic = cell.traffic
        out = copy_harness.run_cell(small, 9, 0.5, True, "cpu", cfg=cfg)
    finally:
        sys.path.remove(str(root))
        for k in [k for k in sys.modules
                  if k == "perfbench" or k.startswith("perfbench.")]:
            del sys.modules[k]
        sys.modules.update(saved)
    assert out["metrics"]["steps_per_s"]["value"] > 0
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
