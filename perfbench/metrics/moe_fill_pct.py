"""Share of the expert capacity rows the window's MoE dispatches computed
(E_l x C per routing group) that held a kept slot: Δ``trace.moe.kept``
over Δ``trace.moe.rows`` (``repro_torch/core/recorder.py``)."""


def read(rec):
    rows = rec.counter("trace.moe.rows")
    if "trace.moe.kept" not in rec.counters1 or not rows:
        return None
    return 100.0 * rec.counter("trace.moe.kept") / rows
