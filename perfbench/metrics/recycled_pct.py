"""Share of the window's block allocations (``fpr.allocs``) served from
the recycling context's own freed blocks (``fpr.recycled_hits``)."""


def read(rec):
    allocs = rec.counter("fpr.allocs")
    return 100.0 * rec.counter("fpr.recycled_hits") / allocs \
        if allocs else None
