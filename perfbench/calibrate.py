"""Readings for a cell's output check, many seeds in one process: for
each seed a short window at the cell's own load, then the program's
widest logit gap and the fp8 control's over the same checked requests.
The limits in ``perfbench/workloads/<cell>.json`` are set from these
readings (PERF.md gives them).  The benchmark's own runs never run it.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 15
"""

from __future__ import annotations

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path[:0] = [os.path.join(os.path.dirname(_HERE), "src"),
                os.path.dirname(_HERE)]

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    import torch
    from perfbench import spec
    from perfbench.harness import run_cell
    cell = spec.load(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, seed, args.seconds, False, device, control=True)
        prog = {**{k: c["value"] for k, c in out["checks"].items()},
                **{k: out["checked"][k] for k in out["control"]
                   if k in out["checked"]}}
        row = {"seed": seed, "correct": out["correct"], "program": prog,
               "control": out["control"], "checked": out["checked"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for k in rows[0]["control"]:
        lower = max(r["program"][k] for r in rows)
        upper = min(r["control"][k] for r in rows)
        summary[k] = {"lower": lower, "upper": upper,
                      "ratio": upper / max(lower, 1e-30)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
