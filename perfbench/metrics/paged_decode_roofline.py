"""The paged_decode kernel's share of its roofline (``_roofline.share``)."""

from perfbench.metrics._roofline import share


def read(rec):
    return share(rec, "paged_decode")
