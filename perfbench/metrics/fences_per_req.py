"""Fences the FPR manager issued in the window (``fence.fences``) over
the requests completed in it."""


def read(rec):
    done = len(rec.completed())
    return rec.counter("fence.fences") / done if done else None
