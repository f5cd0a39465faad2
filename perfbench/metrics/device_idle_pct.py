"""Share of the traced window in which no operation ran on the device
(the union of kernels, copies and sets in the profiler's trace)."""


def read(rec):
    t = rec.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
