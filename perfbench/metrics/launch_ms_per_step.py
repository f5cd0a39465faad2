"""Host time inside the calls of the model entry points per engine step
in the window: the program's ``engine.launch`` spans (the host enqueueing
a step's kernels), Δ``trace.engine.launch_s`` over Δ``trace.engine.steps``
(``repro_torch/core/recorder.py``; absent from a program without the
recorder)."""


def read(rec):
    steps = rec.counter("trace.engine.steps")
    if "trace.engine.launch_s" not in rec.counters1 or not steps:
        return None
    return 1e3 * rec.counter("trace.engine.launch_s") / steps
