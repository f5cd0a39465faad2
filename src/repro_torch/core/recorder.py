"""In-program spans and counters of the serving step, on the profiler's
clock.

:class:`TraceCollector` (``core/tracing.py``) stitches the control
plane's bus events into request and step spans; it cannot tell host time
from device time.  The :class:`SpanRecorder` here times the host work
*inside* ``Engine.step`` from the program itself:

  * ``engine.step`` and, as its children in order, the phases
    ``engine.admit``, ``engine.settle`` (eviction and the pager's
    residency fixpoint), ``engine.grow`` (chunk and decode growth,
    copy-on-write), ``engine.tables`` (``update_tables``),
    ``engine.inputs`` (descriptors and their uploads), ``engine.launch``
    (the call of a model entry point: the host enqueueing its kernels),
    ``engine.wait`` (blocked in the logits' ``.cpu()``) and
    ``engine.emit`` (tokens, completions, the frees' fences).  A
    monolithic prefill's ``engine.inputs`` and ``engine.launch`` nest
    under ``engine.admit``.
  * ``cache.fence`` (``PagedKVCache._device_fence``) with its child
    ``cache.fence.drain`` (the stream ``synchronize``), under whatever
    phase issued the fence.
  * ``model.moe`` inside ``models/moe.moe_ffn``, with its child
    ``model.moe.route`` around the router (host time only), and, while a
    profiler runs, the ranges ``model.embed`` (an entry point's work
    before its first layer), ``model.attn`` (a layer's attention or MLA
    mixer), ``model.scan`` (a Mamba or RWKV-6 mixer), ``model.ffn`` and
    ``model.head`` inside the entry points, and inside a decode step
    served by ``models/decode_graphs.py`` ``model.graph`` (a piece: its
    graph's replay) and ``model.attn`` (the attention kernel called
    between pieces), and around a prefill's replay by
    ``models/prefill_graphs.py`` ``model.prefill.graph``, which are not
    kept.  A replayed step or prefill runs no ``model.moe`` span; the
    graphs hand the recorder its MoE dispatches' slot counts instead.

The admission, residency and table phases open inside ``_admit``,
``_settle_residency`` and ``update_tables``, and the model ranges inside
the entry points, so that a caller's range around those calls (a
benchmark's, say) encloses the program's and the program's is the
innermost.

``engine.launch`` and ``model.moe`` carry an event pair (CUDA events on
the card, :class:`HostEvent` elsewhere) that times the device work they
enqueued; neither blocks the host.

Each span keeps its name, host start and end (``time.perf_counter_ns``),
its parent and its args (``rids``: the requests it served).  Spans are
kept in memory, the newest :data:`CAPACITY`, and written out on demand
(:meth:`SpanRecorder.chrome_trace`, :meth:`SpanRecorder.save`).  Running
totals of every kept engine and cache span and of the MoE router's spans,
the device time of the launches by entry point and of the MoE FFN calls
inside them (their event pairs, read at a snapshot, which waits for
them), the counters of the ragged step's real rows and the MoE
dispatch's slots (those routed to the experts held here, and those
kept), and those of the decode steps and prefills served by graph
replay and of their graphs' captures, are what
:meth:`SpanRecorder.counters` returns; ``Engine.enable_tracing``
registers them as the ``trace`` namespace of the engine's metrics, so
they appear in ``metrics.snapshot()`` and the exporter only while the
recorder is on (:data:`TRACE_SCHEMA`, their kinds in
:data:`TRACE_KINDS`).

**Off**, an engine holds no recorder, and each phase boundary costs one
``is None`` test: no clock read, no allocation, no device work, no
``record_function``.  :data:`ACTIVE` is the recorder of the traced
engine step in progress (None otherwise); the model code reads it.  A
step that finds a ``torch.profiler`` session running switches its
engine's recorder on, so a profiled engine's trace holds the program's
ranges without a call to ``enable_tracing``.

**One clock with the profiler.**  While a ``torch.profiler`` session
runs, every span is also a ``record_function`` range of the same name,
so the profiler places it on its own clock.  The profiler (Kineto)
writes an event's ``ts`` as microseconds of the Unix clock after the
trace's ``baseTimeNanoseconds``, which is the Unix time floored to a
multiple of 7,889,238 s (libkineto's ``ChromeTraceBaseTime``).  The
recorder reads ``perf_counter_ns``; at construction it measures the
offset from that clock to the Unix clock once (``time.time_ns`` read
between two ``perf_counter_ns`` reads, the narrowest of five brackets)
and converts a span's start as ``(t + offset - base) / 1000``
(:meth:`SpanRecorder.profiler_us`).  :meth:`SpanRecorder.chrome_trace`
writes its spans, and a :class:`TraceCollector`'s events moved by the
same conversion, on that base, so the saved file and the profiler's
trace line up in Perfetto.  No name here starts with ``kernel.``.
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager

import torch

from repro_torch.core import metrics as _metrics
from repro_torch.core.tracing import TID_ENGINE

#: the recorder of the traced engine step in progress (read by the model
#: code), None outside one
ACTIVE: "SpanRecorder | None" = None

#: spans kept in memory (the oldest are dropped past it)
CAPACITY = 200_000

#: trace track of the recorder's spans in :meth:`SpanRecorder.chrome_trace`
#: (the collector's engine track is ``TID_ENGINE``)
TID_SPANS = TID_ENGINE + 1

#: libkineto's ChromeTraceBaseTime period, in seconds
BASE_PERIOD_S = 7_889_238

#: seconds totals and counts kept per span name: name -> (group, key)
SECONDS = {
    "engine.step": ("engine", "step_s"),
    "engine.admit": ("engine", "admit_s"),
    "engine.settle": ("engine", "settle_s"),
    "engine.grow": ("engine", "grow_s"),
    "engine.tables": ("engine", "tables_s"),
    "engine.inputs": ("engine", "inputs_s"),
    "engine.launch": ("engine", "launch_s"),
    "engine.wait": ("engine", "wait_s"),
    "engine.emit": ("engine", "emit_s"),
    "cache.fence": ("cache", "fence_s"),
    "cache.fence.drain": ("cache", "drain_s"),
    "model.moe.route": ("moe", "route_s"),
}
COUNTS = {
    "engine.step": ("engine", "steps"),
    "engine.launch": ("engine", "launches"),
    "cache.fence": ("cache", "fences"),
    "cache.fence.drain": ("cache", "drains"),
}

#: the model entry points an ``engine.launch`` span calls (its ``entry``)
ENTRIES = ("decode_step", "prefill", "prefill_chunk", "ragged_step")
#: event pairs are read into the device totals at a snapshot, or at a
#: step's end once this many wait
PENDING = 4096

#: the ``trace.*`` snapshot keys and their kinds (an optional group, like
#: ``metrics.KERNEL_SCHEMA``: present only while a recorder is on)
TRACE_KINDS = {
    **{f"trace.{g}.{k}": "counter" for g, k in SECONDS.values()},
    **{f"trace.{g}.{k}": "counter" for g, k in COUNTS.values()},
    # by entry point: its launches, their device time, and the device
    # time of the MoE FFN calls inside them
    **{f"trace.launch.{e}.{k}": "counter" for e in ENTRIES
       for k in ("calls", "device_s", "moe_s")},
    # MoE dispatch: routed (token, k) slots, those routed to the experts
    # held here (all of them unless the layer holds a share), those kept
    # under each expert's capacity, and the E_l x C rows the expert
    # products compute
    "trace.moe.here": "counter",
    "trace.moe.kept": "counter",
    "trace.moe.rows": "counter",
    "trace.moe.slots": "counter",
    # decode steps served by replaying the piecewise graphs, and the
    # captures of those graphs (recaptures included)
    "trace.decode.captures": "counter",
    "trace.decode.graph_steps": "counter",
    # monolithic prefills served by replaying a padded length's graph,
    # and the captures of those graphs (recaptures included)
    "trace.prefill.captures": "counter",
    "trace.prefill.graph_calls": "counter",
    # ragged step: real token rows and the t_cap rows computed
    "trace.ragged.rows_cap": "counter",
    "trace.ragged.rows_real": "counter",
    "trace.spans.dropped": "counter",
    "trace.spans.kept": "gauge",
}
TRACE_SCHEMA = tuple(sorted(TRACE_KINDS))
# the exporter reads kinds from the registry's table; core/metrics.py is
# the reference's copy and holds only the reference's groups
_metrics.SCHEMA_KINDS.update(TRACE_KINDS)

#: the profiler-range name of each serving mixer
MIXER_RANGE = {"attn": "model.attn", "mla": "model.attn",
               "mamba": "model.scan", "rwkv6": "model.scan"}

profiling = torch._C._autograd._profiler_enabled


class HostEvent:
    """A stand-in for ``torch.cuda.Event`` off the card: the host clock
    at :meth:`record`."""

    __slots__ = ("t",)

    def __init__(self, enable_timing: bool = True):
        self.t = None

    def record(self) -> None:
        self.t = time.perf_counter_ns()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) / 1e6


class Span:
    __slots__ = ("id", "name", "parent", "t0", "t1", "args", "events",
                 "keep", "rf")

    def __init__(self, sid, name, parent, args, keep):
        self.id = sid
        self.name = name
        self.parent = parent
        self.args = args
        self.keep = keep
        self.events = None
        self.rf = None
        self.t0 = self.t1 = None

    def device_ms(self) -> "float | None":
        """Device time between the span's events (waits for the end
        event), None for a span without events."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def unix_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, read inside the
    narrowest of five brackets."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        u = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, u - (p0 + p1) // 2)
    return best[1]


def profiler_base_ns(unix_ns: int) -> int:
    """The ``baseTimeNanoseconds`` of a profiler trace taken at
    ``unix_ns``."""
    period = BASE_PERIOD_S * 10**9
    return unix_ns // period * period


class SpanRecorder:
    """Spans and running totals of one engine (see the module doc)."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.spans: deque = deque(maxlen=CAPACITY)
        self._stack: list[Span] = []       # open spans, outermost first
        self._model: "Span | None" = None  # the open model-level span
        self._ids = 0
        self._kept = 0
        self._ns = dict.fromkeys(SECONDS.values(), 0)
        self._n = dict.fromkeys(COUNTS.values(), 0)
        self.rows_real = self.rows_cap = 0
        self.moe_slots = self.moe_rows = 0
        self.graph_steps = self.graph_captures = 0
        self.prefill_graph_calls = self.prefill_captures = 0
        self._moe_kept = None               # device tensors, read at snapshot
        self._moe_here = None
        self._pending: list[Span] = []      # event pairs not yet read
        # entry point -> [launches, their device ms, MoE device ms]
        self._device = {e: [0, 0.0, 0.0] for e in ENTRIES}
        self.unix_offset_ns = unix_offset_ns()
        self.base_ns = profiler_base_ns(time.perf_counter_ns()
                                        + self.unix_offset_ns)

    # ----------------------------------------------------------------- spans
    def _event(self):
        return (torch.cuda.Event(enable_timing=True) if self.cuda
                else HostEvent())

    def open(self, name: str, args: "dict | None" = None,
             events: bool = False, keep: bool = True) -> Span:
        """Open ``name`` as a child of the innermost open span."""
        stack = self._stack
        sp = Span(self._ids, name, stack[-1].id if stack else None, args,
                  keep)
        self._ids += 1
        if args and "rids" in args and stack:
            stack[0].args.setdefault("rids", []).extend(args["rids"])
        sp.t0 = time.perf_counter_ns()
        if profiling():
            sp.rf = torch.autograd.profiler.record_function(name)
            sp.rf.__enter__()
        if events:
            sp.events = (self._event(), self._event())
            sp.events[0].record()
        stack.append(sp)
        return sp

    def close(self) -> None:
        """Close the innermost open span."""
        sp = self._stack.pop()
        if sp.events is not None:
            sp.events[1].record()
        if sp.rf is not None:
            sp.rf.__exit__(None, None, None)
            sp.rf = None
        sp.t1 = time.perf_counter_ns()
        if not sp.keep:
            return
        self.spans.append(sp)
        self._kept += 1
        key = SECONDS.get(sp.name)
        if key is not None:
            self._ns[key] += sp.t1 - sp.t0
        key = COUNTS.get(sp.name)
        if key is not None:
            self._n[key] += 1
        if sp.events is not None:
            self._pending.append(sp)
        if sp.name == "engine.step" and len(self._pending) > PENDING:
            self._resolve()

    def _resolve(self) -> None:
        """Add the pending spans' device times to the totals (waits for
        their end events)."""
        for sp in self._pending:
            tot = self._device[sp.args["entry"]]
            if sp.name == "model.moe":
                tot[2] += sp.device_ms()
            else:
                tot[0] += 1
                tot[1] += sp.device_ms()
        self._pending = []

    def _close_to(self, depth: int) -> None:
        while len(self._stack) > depth:
            if self._stack[-1] is self._model:
                self._model = None
            self.close()

    def phase(self, name: str, args: "dict | None" = None,
              events: bool = False) -> None:
        """Close the step's open phase (and anything inside it) and open
        ``name`` as the step's next child."""
        self._close_to(1 if self._stack else 0)
        self.open(name, args, events)

    def model(self, name: "str | None") -> None:
        """Switch the model-level range: close the open one, then open
        ``name`` (None: none).  ``model.moe`` is a kept span with an event
        pair; every other name is a profiler range only, opened only while
        a profiler runs."""
        if self._model is not None:
            self._close_to(self._stack.index(self._model))
        if name is None:
            return
        if name == "model.moe":
            entry = next(s.args["entry"] for s in reversed(self._stack)
                         if s.name == "engine.launch")
            self._model = self.open(name, {"entry": entry}, events=True)
        elif profiling():
            self._model = self.open(name, keep=False)

    @contextmanager
    def step(self, index: int):
        """One ``engine.step`` span around the body; the recorder is
        :data:`ACTIVE` inside it, and every span the body left open is
        closed at its end."""
        global ACTIVE
        prev, ACTIVE = ACTIVE, self
        depth = len(self._stack)
        self.open("engine.step", {"step": index})
        try:
            yield self
        finally:
            self._close_to(depth)
            ACTIVE = prev

    # -------------------------------------------------------------- counters
    def ragged_rows(self, real: int, cap: int) -> None:
        self.rows_real += real
        self.rows_cap += cap

    def moe_fill(self, slots: int, kept: torch.Tensor, rows: int,
                 here: torch.Tensor) -> None:
        """One MoE dispatch: ``slots`` routed, ``here`` and ``kept`` the
        (device) masks of the slots routed to the experts held here and
        of those kept, ``rows`` computed; the two counts stay on the
        device until a snapshot reads them."""
        self.moe_slots += slots
        self.moe_rows += rows
        n, h = kept.sum(), here.sum()
        if self._moe_kept is None:
            self._moe_kept, self._moe_here = n, h
        else:
            self._moe_kept.add_(n)
            self._moe_here.add_(h)

    def decode_graph(self, captured: bool) -> None:
        """One decode step of the piecewise graphs: one that captured
        them (and ran eagerly), or one served by their replay."""
        if captured:
            self.graph_captures += 1
        else:
            self.graph_steps += 1

    def prefill_graph(self, captured: bool) -> None:
        """One monolithic prefill of the graphs: one that captured its
        padded length's graph (and ran eagerly), or one served by a
        replay."""
        if captured:
            self.prefill_captures += 1
        else:
            self.prefill_graph_calls += 1

    def counters(self) -> dict:
        """The running totals (the ``trace`` namespace of the metrics); a
        snapshot waits for the MoE slot counts."""
        out: dict = {"engine": {}, "cache": {}, "moe": {}}
        for (group, key), ns in self._ns.items():
            out[group][key] = ns / 1e9
        for (group, key), n in self._n.items():
            out[group][key] = n
        self._resolve()
        out["launch"] = {e: {"calls": n, "device_s": ms / 1e3,
                             "moe_s": moe_ms / 1e3}
                         for e, (n, ms, moe_ms) in self._device.items()}
        kept = here = 0
        if self._moe_kept is not None:
            kept, here = (int(self._moe_kept.item()),
                          int(self._moe_here.item()))
        out["moe"].update(here=here, kept=kept, rows=self.moe_rows,
                          slots=self.moe_slots)
        out["decode"] = {"captures": self.graph_captures,
                         "graph_steps": self.graph_steps}
        out["prefill"] = {"captures": self.prefill_captures,
                          "graph_calls": self.prefill_graph_calls}
        out["ragged"] = {"rows_cap": self.rows_cap,
                         "rows_real": self.rows_real}
        out["spans"] = {"dropped": self._kept - len(self.spans),
                        "kept": len(self.spans)}
        return out

    # ---------------------------------------------------------------- export
    def profiler_us(self, perf_ns: int) -> float:
        """A ``perf_counter_ns`` reading as a profiler ``ts`` (module
        doc)."""
        return (perf_ns + self.unix_offset_ns - self.base_ns) / 1e3

    def chrome_trace(self, collector=None) -> dict:
        """The kept spans as Chrome-trace events on the profiler's time
        base (their device time as the ``device_ms`` arg), merged with
        ``collector``'s events (a :class:`TraceCollector` on the default
        clock, moved onto the same base)."""
        pid = 1
        events = []
        meta = []
        if collector is not None:
            if collector._clock is not time.perf_counter:
                raise ValueError("a collector on its own clock cannot be "
                                 "placed on the profiler's")
            pid = collector.pid
            shift = self.profiler_us(round(collector._t0 * 1e9))
            payload = collector.chrome_trace()
            for e in payload["traceEvents"]:
                if "ts" in e:
                    e = dict(e, ts=e["ts"] + shift)
                    events.append(e)
                else:
                    meta.append(e)
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": TID_SPANS,
                     "args": {"name": "engine phases (host)"}})
        for sp in self.spans:
            args = dict(sp.args or {}, id=sp.id, parent=sp.parent)
            ms = sp.device_ms()
            if ms is not None:
                args["device_ms"] = ms
            events.append({"name": sp.name, "cat": "span", "ph": "X",
                           "ts": self.profiler_us(sp.t0),
                           "dur": (sp.t1 - sp.t0) / 1e3, "pid": pid,
                           "tid": TID_SPANS, "args": args})
        return {"traceEvents": meta + sorted(events, key=lambda e: e["ts"]),
                "displayTimeUnit": "ms", "baseTimeNanoseconds": self.base_ns}

    def save(self, path: str, collector=None) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(collector), f)
        return path


__all__ = ["ACTIVE", "CAPACITY", "HostEvent", "MIXER_RANGE", "Span",
           "SpanRecorder", "TRACE_KINDS", "TRACE_SCHEMA", "profiler_base_ns",
           "unix_offset_ns"]
