"""Prometheus text-format export for the unified metrics snapshot.

Dependency-free (stdlib only) rendering of
:meth:`repro_torch.core.metrics.MetricsRegistry.snapshot` into the Prometheus
text exposition format (v0.0.4), plus an opt-in ``http.server``-based
``/metrics`` endpoint.  Every sample carries a ``key`` label holding the
exact dotted snapshot key, so the exposition **round-trips**: parsing the
text recovers precisely the flat-schema key set CI validates
(:func:`parse_keys`), and no renaming/sanitisation step can silently
drop or alias a counter.

**Kinds matter.**  ``repro_torch.core.metrics.SCHEMA_KINDS`` declares every
schema key a ``counter`` (monotone total — rendered with the ``_total``
suffix), ``gauge`` (level / ratio — ``fpr.prefix.hit_rate`` and the
ledger occupancy export here, never as counters), ``info`` (string
rendered as a constant-``1`` sample with a ``value`` label) or
``histogram`` (cumulative ``_bucket{le=…}`` series + ``_sum``/``_count``
from the registry's fixed-bucket :class:`~repro_torch.core.metrics.Histogram`).

**Paper taxonomy → counter families.**  The source paper's point is that
TLB-shootdown cost was *misattributed* until it was accounted per
mechanism; the exporter keeps that attribution explicit:

  * ``fpr.*`` — the §IV-A allocation-phase checks: ``fpr.recycled_hits``
    is the fence-free reuse the paper's mmap extension enables,
    ``fpr.context_exits`` the checks that found a foreign recycling
    context (the only allocation path that may still fence).
  * ``fence.*`` — the shootdown analogue itself: ``fence.fences`` is the
    paper's IPI broadcast count, ``fence.fences_scoped`` /
    ``fence.replicas_spared`` the worker-scoped narrowing, and
    ``fence.elided_by_version`` / ``fence.elided_by_scope`` the §IV-C5
    deferred invalidations that were already covered.
  * ``fence.obs.scope_workers`` (histogram) — the per-fence scope
    popcount: the broadcast pessimism shows up as mass at the full
    worker count, scoped coherence as mass at 1–2.
  * ``device.*`` — the measured rebroadcast a fence pays
    (``device.refreshed_bytes``; per-fence distribution in the
    ``device.obs.refresh_bytes`` histogram).
  * ``engine.obs.*`` / ``admission.obs.*`` — serving-loop latency
    attribution: step latency, queue wait and admission queue depth as
    fixed-bucket histograms rather than totals-only counters.

Usage::

    from repro_torch.core.export import render_registry, serve
    text = render_registry(engine.metrics)          # scrape body
    srv = serve(engine.metrics, port=9108)          # opt-in endpoint
    ...                                             # GET /metrics
    srv.close()
"""

from __future__ import annotations

import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.core.metrics import MetricsRegistry, kind_of

#: exposition content type (Prometheus text format v0.0.4)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: HELP line per namespace family (first matching prefix wins)
HELP_TEXT = (
    ("fpr.prefix.", "prefix-sharing index (attach/detach, COW, hit rate)"),
    ("fpr.eviction.", "watermark-daemon (kswapd analogue) pass totals"),
    ("fpr.", "allocation-phase fast-page-recycling checks (paper SIV-A)"),
    ("fence.obs.", "per-fence scope popcount distribution"),
    ("fence.", "coherence fences - the TLB-shootdown analogue"),
    ("table.", "host block-table epochs and shard diagnostics"),
    ("device.obs.", "per-fence device-shard refresh size distribution"),
    ("device.", "device block-table refresh traffic (measured rebroadcast)"),
    ("engine.obs.", "serving-loop latency/observability distributions"),
    ("engine.", "continuous-batching serving-loop totals"),
    ("admission.obs.", "admission-round queue-depth distribution"),
    ("admission.", "memory governor admission/preemption accounting"),
)


def prom_name(key: str, kind: "str | None" = None) -> str:
    """Sanitised metric name for ``key``: ``repro_`` prefix, dots to
    underscores, the conventional ``_total`` suffix for counters and
    ``_info`` for string-valued info metrics."""
    name = "repro_" + _NAME_RE.sub("_", key)
    if kind == "counter" and not name.endswith("_total"):
        name += "_total"
    elif kind == "info" and not name.endswith("_info"):
        name += "_info"
    return name


def escape_label(value: str) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote and newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value) -> str:
    """Sample value formatting (bools are 1/0, None is NaN so the key
    still round-trips, floats keep full precision)."""
    if value is None:
        return "NaN"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float):
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        return repr(value)
    return str(value)


def _exemplar_suffix(exemplar) -> str:
    """OpenMetrics exemplar rendered after a ``_bucket`` sample: ``#
    {trace_id="<id>"} <value>``.  ``exemplar`` is the histogram's
    per-bucket ``(trace_id, value)`` pair (``None`` ⇒ no suffix — plain
    v0.0.4 exposition, what every pre-exemplar golden fixture pins)."""
    if exemplar is None:
        return ""
    trace_id, value = exemplar
    return f' # {{trace_id="{escape_label(trace_id)}"}} {_fmt(value)}'


def _help_for(key: str) -> str:
    for prefix, text in HELP_TEXT:
        if key.startswith(prefix):
            return text
    return "repro-fpr metric"


def _emit_header(lines: list, name: str, key: str, prom_type: str,
                 seen: set) -> None:
    if name in seen:
        return
    seen.add(name)
    lines.append(f"# HELP {name} {_help_for(key)}")
    lines.append(f"# TYPE {name} {prom_type}")


def render(snapshot: dict, histograms: "dict | None" = None) -> str:
    """Render a flat snapshot to exposition text.

    ``histograms`` (name → :class:`~repro_torch.core.metrics.Histogram`, as
    from ``registry.histograms``) switches those families from flat
    gauge leaves to proper cumulative ``_bucket``/``_sum``/``_count``
    exposition.  Every sample keeps the originating snapshot key in its
    ``key`` label, so :func:`parse_keys` round-trips the schema.
    """
    histograms = histograms or {}
    hist_prefixes = tuple(f"{n}." for n in histograms)
    lines: list[str] = []
    seen: set[str] = set()

    for name in sorted(histograms):
        hist = histograms[name]
        mname = prom_name(name, "histogram")
        _emit_header(lines, mname, name, "histogram", seen)
        kl = f'key="{escape_label(name)}"'
        exemplars = getattr(hist, "exemplars",
                            [None] * len(hist.counts))
        cum = 0
        for i, (bound, count) in enumerate(zip(hist.bounds, hist.counts)):
            cum += count
            lines.append(f'{mname}_bucket{{{kl},le="{_fmt(float(bound))}"}}'
                         f" {cum}{_exemplar_suffix(exemplars[i])}")
        lines.append(f'{mname}_bucket{{{kl},le="+Inf"}} {hist.count}'
                     f"{_exemplar_suffix(exemplars[-1])}")
        lines.append(f"{mname}_sum{{{kl}}} {_fmt(hist.sum)}")
        lines.append(f"{mname}_count{{{kl}}} {hist.count}")

    for key, value in snapshot.items():
        if any(key.startswith(p) for p in hist_prefixes):
            continue                    # rendered as a real histogram above
        kind = kind_of(key)
        if kind == "histogram":
            kind = "gauge"              # flat leaf of an unregistered hist
        if isinstance(value, str) or kind == "info":
            mname = prom_name(key, "info")
            _emit_header(lines, mname, key, "gauge", seen)
            lines.append(f'{mname}{{key="{escape_label(key)}",'
                         f'value="{escape_label(value)}"}} 1')
            continue
        prom_type = "counter" if kind == "counter" else "gauge"
        mname = prom_name(key, kind)
        _emit_header(lines, mname, key, prom_type, seen)
        kl = f'key="{escape_label(key)}"'
        if isinstance(value, (list, tuple)):
            for i, item in enumerate(value):
                lines.append(f'{mname}{{{kl},index="{i}"}} {_fmt(item)}')
        else:
            lines.append(f"{mname}{{{kl}}} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def render_registry(registry: MetricsRegistry) -> str:
    """One-call scrape body for a live registry (counters + histograms)."""
    return render(registry.snapshot(), registry.histograms)


_KEY_LABEL_RE = re.compile(r'key="((?:[^"\\]|\\.)*)"')


def parse_keys(text: str) -> set:
    """The snapshot keys present in an exposition body (round-trip check:
    ``parse_keys(render_registry(reg)) == set(reg.snapshot())`` up to
    histogram leaf expansion)."""
    keys = set()
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _KEY_LABEL_RE.search(line)
        if m:
            keys.add(m.group(1).replace('\\"', '"').replace("\\n", "\n")
                     .replace("\\\\", "\\"))
    return keys


# ------------------------------------------------------------------ endpoint
class MetricsServer:
    """Opt-in stdlib ``/metrics`` endpoint over a
    :class:`~repro_torch.core.metrics.MetricsRegistry`.

    ``MetricsServer(registry, port=0)`` binds (port 0 picks a free one —
    see :attr:`port`), serves ``GET /metrics`` from a daemon thread, 404s
    everything else, and :meth:`close` shuts the listener down.  Usable
    as a context manager.
    """

    def __init__(self, registry: MetricsRegistry, *, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 — http.server API
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404, "only /metrics is served")
                    return
                body = render_registry(server.registry).encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):   # quiet by default
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-metrics",
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve(registry: MetricsRegistry, *, port: int = 0,
          host: str = "127.0.0.1") -> MetricsServer:
    """Start the opt-in ``/metrics`` endpoint; returns the running
    :class:`MetricsServer` (``.url``, ``.close()``)."""
    return MetricsServer(registry, port=port, host=host)


__all__ = ["CONTENT_TYPE", "HELP_TEXT", "MetricsServer", "escape_label",
           "parse_keys", "prom_name", "render", "render_registry", "serve"]
