"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W power limit).  Rooflines and MFU are stated against
these whatever precision an implementation uses, so the same work reads
the same bound; the card's power limit is printed beside them."""

BF16_FLOPS = 989e12         # FLOP/s, bf16 and fp16 tensor cores
HBM_BYTES = 3.35e12         # bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
