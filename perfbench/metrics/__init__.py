"""One reader a metric: ``<name>.py`` holds ``read(rec)`` over a
``window.Record``, returning the metric's value, or None where the run
has nothing for it to read (the harness then leaves the metric out)."""
