"""What the engine's span recorder costs: untraced runs of a benchmark
cell (``perfbench``, no profiler) with the recorder off and on, in turns
(off, on, on, off) on each seed, in one process on one card.

    python tools/trace_cost.py --workload granite-3-8b.chat \\
        --seeds 2147483659 --seconds 20

Prints one JSON line a run: the seed, whether the recorder was on,
``tokens_per_s`` and ``correct``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    # the host threads of perfbench/run.py
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "2")
    import torch
    torch.set_num_threads(2)
    from perfbench import harness, model, spec
    cell = spec.load(args.workload)
    build = model.build_engine
    for seed in args.seeds:
        for on in (False, True, True, False):
            def build_engine(*a, on=on, **k):
                eng = build(*a, **k)
                if on:
                    eng.enable_tracing()
                return eng
            model.build_engine = build_engine
            out = harness.run_cell(cell, seed, args.seconds, False, "cuda")
            print(json.dumps({
                "workload": args.workload, "seed": seed, "recorder": on,
                "tokens_per_s": out["metrics"]["tokens_per_s"]["value"],
                "correct": out["correct"]}), flush=True)
    model.build_engine = build


if __name__ == "__main__":
    main()
