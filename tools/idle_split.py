"""One traced run of a benchmark cell (``perfbench/run.py --trace 1``),
with the device's idle time in the profiled window split by the model
entry point open when each gap began (``prefill``, ``decode_step``, ...:
the benchmark's ranges around them), then by the innermost range, and
the mean host time of the program's and the benchmark's ranges inside
each entry point (``model.graph``, ``model.attn``, ``kernel.<name>``...).
The benchmark's own breakdown names only the innermost range, which the
decode step and the prefill share (``model.attn``).

    python tools/idle_split.py --workload granite-3-8b.chat --seed N \\
        [--seconds 50] [--out FILE]

Prints the run's result line as ``run.py`` does, then one JSON line
``{"idle_s": {entry: {range: s}}, "host_ms": {entry: {range: [calls,
mean ms]}}}`` (also written to ``--out``).  Needs the card, as
``run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUTSIDE = "outside every entry point"


def split(events) -> dict:
    """The two tables of the module doc from the profiler's events
    (``perfbench.trace.Tracer.profile_events``)."""
    from perfbench import trace as tr
    w0, w1 = next((s, e) for k, n, s, e, _ in events
                  if k == "annotation" and n == tr.WINDOW)
    ann = sorted(((s, e, n) for k, n, s, e, _ in events
                  if k == "annotation" and n != tr.WINDOW),
                 key=lambda a: (a[0], -a[1]))
    starts = np.array([a[0] for a in ann], dtype=np.int64)
    ent = [a for a in ann if a[2] in tr.ENTRY_POINTS]
    estarts = np.array([a[0] for a in ent], dtype=np.int64)
    busy = tr._merge([(max(s, w0), min(e, w1)) for k, _, s, e, _ in events
                      if k == "device" and e > w0 and s < w1])
    idle: dict = {}
    t = w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            entry = tr._innermost(ent, estarts, t) or OUTSIDE
            inner = tr._innermost(ann, starts, t) or tr.OUTSIDE
            row = idle.setdefault(entry, {})
            row[inner] = row.get(inner, 0.0) + (s - t) / 1e9
        t = max(t, e)
    host: dict = {}
    for s, e, n in ann:
        if n in tr.ENTRY_POINTS or not w0 <= s < w1:
            continue
        entry = tr._innermost(ent, estarts, s)
        if entry is None:
            continue
        calls, ns = host.setdefault(entry, {}).get(n, (0, 0))
        host[entry][n] = (calls + 1, ns + e - s)
    return {"idle_s": idle,
            "host_ms": {k: {n: [c, ns / c / 1e6] for n, (c, ns) in v.items()}
                        for k, v in host.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import run as bench
    from perfbench import trace as tr
    kept = {}
    reduce = tr.reduce

    def keep(events):
        kept["split"] = split(events)
        return reduce(events)
    tr.reduce = keep
    rc = bench.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])
    if rc or "split" not in kept:
        return rc or 1
    line = json.dumps(kept["split"])
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
