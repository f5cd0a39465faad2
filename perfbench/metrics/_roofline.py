"""A kernel's share of its roofline: the bound from ``perfbench/work``
(the larger of its useful FLOPs at 989 TFLOP/s and its bytes at
3.35 TB/s) over its device time summed from the profiler's trace (the
device operations launched inside its wrapper's range)."""

import importlib

from perfbench import peaks


def share(rec, kernel: str):
    if rec.trace is None or rec.tracer is None:
        return None
    w = importlib.import_module(f"perfbench.work.{kernel}")
    calls = getattr(rec.tracer, w.CALLS)
    n = w.layers(rec.dims)
    if not calls or not n:
        return None
    secs = rec.trace["kernel_time"].get(kernel, 0.0)
    if not secs:
        return None
    flops = nbytes = 0.0
    for call in calls:
        f, b = w.work(call, rec.dims)
        flops += f * n
        nbytes += b * n
    return 100.0 * peaks.bound_s(flops, nbytes) / secs
