"""Device time spanned by the MoE FFN calls inside one ``decode_step``,
averaged over the window's decode steps."""


def read(rec):
    tr = rec.tracer
    per = [tr.span_ms(p) for p in tr.moe_per_decode if p] if tr else []
    return sum(per) / len(per) if per else None
