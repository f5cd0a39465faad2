"""Share of the window's decode steps served by replaying the decode
step's piecewise CUDA graphs (``repro_torch/models/decode_graphs.py``):
Δ``trace.decode.graph_steps`` over Δ``trace.launch.decode_step.calls``
(``repro_torch/core/recorder.py``; absent from a program without the
graphs)."""


def read(rec):
    calls = rec.counter("trace.launch.decode_step.calls")
    if "trace.decode.graph_steps" not in rec.counters1 or not calls:
        return None
    return 100.0 * rec.counter("trace.decode.graph_steps") / calls
