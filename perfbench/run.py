"""Run one cell of ``BENCHMARK.json`` once on the chip and print one JSON
line (the last line of standard output).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from the traced run.  Exits non-zero, printing no
result, without CUDA or with fewer cards than the cell asks for, or if
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once
the window has closed.  The port's kernels build into
``build/repro_torch_kernels`` inside the checkout (the first run of a
checkout builds them).
"""

from __future__ import annotations

import os
import sys
import time

T_IMPORT = time.perf_counter()
# run as a script, this file's folder leads sys.path: take it out, so that
# no module here (trace.py) hides a standard one
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(_HERE).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HOST_THREADS = 2


def process_age() -> float | None:
    """Seconds since this process started (``/proc``), or None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


def result_line(out: dict, chips: int, kind: str, power: str) -> dict:
    """The last line: ``run_cell``'s result with the card's fields in
    ``device`` and the compared numbers (``checks``) last."""
    line = dict(out)
    checks = line.pop("checks")
    line["device"] = {"platform": "gpu", "kind": kind, "count": chips,
                      "power_limit": power, **out["device"]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    # one process drives the chip: its host work is one Python thread,
    # so the math libraries keep to a few threads of their own
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, str(HOST_THREADS))
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    from perfbench import spec
    cell = spec.load(args.workload, ROOT)
    import torch
    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from perfbench.harness import run_cell
    age = process_age
    if age() is None:
        def age():
            return time.perf_counter() - T_IMPORT
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   age=age)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    line = result_line(out, cell.chips, torch.cuda.get_device_name(0),
                       power_limit())
    print(f"setup phases (s from the harness's start) {line['setup']}",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
