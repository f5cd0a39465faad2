"""Device time spanned per ``decode_step`` call (CUDA events)."""


def read(rec):
    calls = rec.tracer.spans["decode_step"] if rec.tracer else []
    return rec.tracer.span_ms(calls) / len(calls) if calls else None
