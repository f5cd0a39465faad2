"""Work from shapes: a kernel's useful operations and bytes
(``<kernel>.py``: ``WRAPS``, the port's wrapper that launches it;
``CALLS``, the tracer's list of its calls' inputs; ``layers(dims)`` and
``work(call, dims)``), and the model's useful FLOPs a token
(``model.py``).  Each input byte is counted once and each
output byte once, at the real lengths of the call, whatever the kernel
reads again; padding and inactive slots count nothing."""


def resident_keys(tables, b: int, n: int, block: int) -> int:
    """Keys ``0 .. n-1`` of slot ``b`` whose block is resident."""
    cols = tables[b, :-(-n // block)] if n else tables[b, :0]
    full = int((cols[:-1] >= 0).sum()) * block if len(cols) > 1 else 0
    last = (n - (len(cols) - 1) * block) if len(cols) and cols[-1] >= 0 else 0
    return full + last


def kernels() -> list:
    """The names of the kernel modules here (those with ``WRAPS``)."""
    import importlib
    import pkgutil
    out = []
    for m in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{m.name}")
        if hasattr(mod, "WRAPS"):
            out.append(m.name)
    return sorted(out)
