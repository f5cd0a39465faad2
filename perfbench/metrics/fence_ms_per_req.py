"""Host time of the window's fences (the program's ``cache.fence`` spans:
drain the stream, re-upload the table shards), Δ``trace.cache.fence_s``,
over the requests completed in the window
(``repro_torch/core/recorder.py``)."""


def read(rec):
    done = len(rec.completed())
    if "trace.cache.fence_s" not in rec.counters1 or not done:
        return None
    return 1e3 * rec.counter("trace.cache.fence_s") / done
