"""Host time of the MoE router per ``Engine.step``: Δ``trace.moe.route_s``
(the program's ``model.moe.route`` spans, ``repro_torch/core/
recorder.py``) over Δ``trace.engine.steps``, in ms.  None where the
program has no such span."""


def read(rec):
    steps = rec.counter("trace.engine.steps")
    if "trace.moe.route_s" not in rec.counters1 or not steps:
        return None
    return 1e3 * rec.counter("trace.moe.route_s") / steps
