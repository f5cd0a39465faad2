"""Prompt tokens prefilled plus tokens generated inside the window, over
the window's seconds; partial requests count."""


def read(rec):
    n = sum(b - a for _, a, b in rec.prefilled()) + len(rec.outputs())
    return n / rec.window_s
