"""Per ``Engine.step`` in the window: its host-clock time less the device
time spanned by the model entry points called inside it (CUDA events),
averaged over the window's steps."""


def read(rec):
    tr = rec.tracer
    if tr is None or not tr.steps:
        return None
    host = [s * 1e3 - tr.span_ms(pairs) for s, pairs in tr.steps]
    return sum(host) / len(host)
