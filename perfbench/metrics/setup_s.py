"""Process start to the window's start: imports, the kernels' build or
load, weights, the engine and its pool, and the warm-up."""


def read(rec):
    return rec.setup_s
