"""Share of the token rows the window's ragged steps computed that were
real (not padding): Δ``trace.ragged.rows_real`` over
Δ``trace.ragged.rows_cap`` (``repro_torch/core/recorder.py``)."""


def read(rec):
    cap = rec.counter("trace.ragged.rows_cap")
    if "trace.ragged.rows_real" not in rec.counters1 or not cap:
        return None
    return 100.0 * rec.counter("trace.ragged.rows_real") / cap
