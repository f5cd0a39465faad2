"""The whole step's share of the chip's bf16 peak: the useful model
FLOPs of the window's tokens (``work/model.py``: each prompt position
once, each generated token fed back once, the LM head for each output
token; padding and recomputation never) over the window's seconds and
989 TFLOP/s."""

from perfbench import peaks
from perfbench.work import model


def read(rec):
    c = rec.cell.config
    fwd = ctx = 0
    for r, a, b in rec.prefilled():
        fwd += b - a
        ctx += (b * (b + 1) - a * (a + 1)) // 2
    outs = rec.outputs()
    for r, j in outs:
        if j:                       # token j-1 fed back at prompt + j - 1
            fwd += 1
            ctx += r.prompt_len + j
    flops = (fwd * model.token_flops(c) + model.attention_flops(c, ctx)
             + len(outs) * model.head_flops(c))
    return 100.0 * flops / rec.window_s / peaks.BF16_FLOPS
