"""95th percentile over every gap between two consecutive output tokens
of a request, both made inside the window, pooled over all requests."""

from perfbench.window import p95


def read(rec):
    gaps = [(b - a) * 1e3 for r in rec.reqs
            for a, b in zip(r.times, r.times[1:])
            if rec.inside(a) and rec.inside(b)]
    return p95(gaps)
