"""95th percentile of the time to first token over every request whose
first token came inside the window, from its submit."""

from perfbench.window import p95


def read(rec):
    v = p95([(r.times[0] - r.submit_t) * 1e3 for r in rec.reqs
             if r.times and rec.inside(r.times[0])])
    return v
