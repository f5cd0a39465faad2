"""What happened inside the measured window, read from the loop's
requests: the record every metric reader takes.

A token or a prefilled prompt token belongs to the window when the step
that made it ended inside ``(t0, t1]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def p95(values) -> float | None:
    """The 95th percentile by nearest rank (None for no values)."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


@dataclass
class Record:
    cell: object              # spec.Cell
    dims: dict                # the kernels' shapes (run.dims)
    t0: float
    t1: float
    setup_s: float
    reqs: list
    counters0: dict
    counters1: dict
    steps: int                # engine steps in the window
    tracer: object = None     # trace.Tracer (traced runs)
    trace: dict | None = None  # trace.reduce (traced runs)
    paused: float = 0.0       # the profiler's stop inside the window

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0 - self.paused

    def inside(self, t: float) -> bool:
        return self.t0 < t <= self.t1

    def counter(self, key: str) -> float:
        return self.counters1.get(key, 0) - self.counters0.get(key, 0)

    def prefilled(self) -> list:
        """(request, first, end) of every prefill inside the window."""
        return [(r, a, b) for r in self.reqs for t, a, b in r.prefills
                if self.inside(t)]

    def outputs(self) -> list:
        """(request, token index) of every token made inside the window."""
        return [(r, j) for r in self.reqs for j, t in enumerate(r.times)
                if self.inside(t)]

    def completed(self) -> list:
        return [r for r in self.reqs
                if r.done_t is not None and self.inside(r.done_t)]
