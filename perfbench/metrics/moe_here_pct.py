"""Share of the window's routed MoE slots that land on the experts this
chip holds, before capacity: Δ``trace.moe.here`` over
Δ``trace.moe.slots`` (``repro_torch/core/recorder.py``).  None where the
program has no such counter."""


def read(rec):
    slots = rec.counter("trace.moe.slots")
    if "trace.moe.here" not in rec.counters1 or not slots:
        return None
    return 100.0 * rec.counter("trace.moe.here") / slots
