"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``), a
traffic mix (``perfbench/traffic/<traffic>.json``) and has a file of its
own, ``perfbench/workloads/<cell>.json`` (the engine's options and the
limits of the output check).  Its metrics are the ``end_to_end`` and
``per_layer`` entries that list it under ``workloads`` (or list no
cells at all), each read by ``perfbench/metrics/<name>.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "perfbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as run
    traffic: dict         # the traffic mix's parameters
    workload: dict        # the engine's options and the check's limits
    end_to_end: list      # metric entries of BENCHMARK.json
    per_layer: list


def _for(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with every file it names; raises ``KeyError``
    for a cell ``BENCHMARK.json`` does not have."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    pkg = root / "perfbench"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads(
            (pkg / "traffic" / f"{w['traffic']}.json").read_text()),
        workload=json.loads((pkg / "workloads" / f"{name}.json").read_text()),
        end_to_end=_for(bench["end_to_end"], name),
        per_layer=_for(bench["per_layer"], name))
