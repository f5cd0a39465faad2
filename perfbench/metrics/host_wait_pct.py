"""Share of the window's engine-step host time spent blocked on the
device in the logits' copy to the host: the program's ``engine.wait``
spans over its ``engine.step`` spans, Δ``trace.engine.wait_s`` over
Δ``trace.engine.step_s`` (``repro_torch/core/recorder.py``)."""


def read(rec):
    step_s = rec.counter("trace.engine.step_s")
    if "trace.engine.wait_s" not in rec.counters1 or not step_s:
        return None
    return 100.0 * rec.counter("trace.engine.wait_s") / step_s
