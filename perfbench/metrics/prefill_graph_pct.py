"""Share of the window's monolithic prefills served by replaying a padded
length's CUDA graph (``repro_torch/models/prefill_graphs.py``):
Δ``trace.prefill.graph_calls`` over Δ``trace.launch.prefill.calls``
(``repro_torch/core/recorder.py``; absent from a program without the
graphs)."""


def read(rec):
    calls = rec.counter("trace.launch.prefill.calls")
    if "trace.prefill.graph_calls" not in rec.counters1 or not calls:
        return None
    return 100.0 * rec.counter("trace.prefill.graph_calls") / calls
