"""Device time spanned by monolithic ``prefill`` calls per 1000 real
prompt tokens (padding to the block not counted)."""


def read(rec):
    tr = rec.tracer
    if tr is None or not tr.spans["prefill"] or not tr.prefill_tokens:
        return None
    return tr.span_ms(tr.spans["prefill"]) / (sum(tr.prefill_tokens) / 1e3)
