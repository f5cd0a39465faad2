"""Span/trace layer over the control-plane EventBus (Chrome-trace export).

The paper's "shootdowns were misattributed" lesson is an argument for
*where-did-the-time-go* tracing, not just totals: this module subscribes
to the stack's :class:`~repro_torch.core.events.EventBus` and stitches the
existing event stream into spans —

  * one **root span per request**, opened by the governor's
    ``AdmissionDecision(decision="admit")`` and closed by the engine's
    ``RequestCompleted`` (queue depth at admission and decoded-token
    count ride along as span args);
  * ``PrefillChunkDone`` becomes a child span on the request's track
    (one per fixed-shape chunk, labelled with its token range);
  * every ``Engine.step`` is a span on the shared engine track
    (``StepCompleted`` carries the wall duration; the start is
    reconstructed as ``now - wall_s``), and every ``FenceIssued`` /
    ``ShardRefreshed`` published *during* the step lands inside it as a
    child event on the same track — fences nest under the step that paid
    them, which is exactly the attribution the flat counters cannot give;
  * ``PreemptionResolved`` and ``TopologyChanged`` are instant markers.

Export is the Chrome trace-event JSON format (``chrome://tracing`` /
Perfetto ``ui.perfetto.dev`` both open it): :meth:`TraceCollector.
chrome_trace` returns the dict, :meth:`TraceCollector.save` writes it.

Timestamps come from an injectable ``clock`` (seconds; default
``time.perf_counter``) so tests can drive a virtual clock; trace ``ts``
are microseconds relative to collector construction.  The collector is
an observability subscriber only — it never mutates the stack, and a
raising handler is isolated by the bus's subscriber-error containment.
"""

from __future__ import annotations

import json
import time
from typing import Callable

from repro_torch.core.events import (AdmissionDecision, EventBus, FenceIssued,
                               PrefillChunkDone, PreemptionResolved,
                               RequestCompleted, ShardRefreshed,
                               StepCompleted, TopologyChanged)

#: trace track (tid) of engine steps + coherence events; request root
#: spans get ``TID_REQUEST_BASE + rid`` so every request is its own row
TID_ENGINE = 0
TID_REQUEST_BASE = 1000


class TraceCollector:
    """Subscribe to a stack's bus and accumulate Chrome-trace events.

    ``TraceCollector(bus)`` attaches immediately; :meth:`detach` removes
    every subscription.  ``pid`` namespaces multi-engine traces.
    """

    def __init__(self, bus: EventBus, *, pid: int = 1,
                 clock: "Callable[[], float] | None" = None):
        self.bus = bus
        self.pid = pid
        self._clock = clock if clock is not None else time.perf_counter
        self._t0 = self._clock()
        self.events: list[dict] = []          # completed trace events
        self._open: dict[int, dict] = {}      # rid → open root span
        self._unsubs = [
            bus.subscribe(AdmissionDecision, self._on_admission),
            bus.subscribe(PrefillChunkDone, self._on_chunk),
            bus.subscribe(StepCompleted, self._on_step),
            bus.subscribe(RequestCompleted, self._on_completed),
            bus.subscribe(FenceIssued, self._on_fence),
            bus.subscribe(ShardRefreshed, self._on_refresh),
            bus.subscribe(PreemptionResolved, self._on_preempt),
            bus.subscribe(TopologyChanged, self._on_reshard),
        ]

    # ------------------------------------------------------------------ time
    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    # ------------------------------------------------------------- lifecycle
    def detach(self) -> None:
        """Unsubscribe from the bus (open spans stay readable)."""
        for unsub in self._unsubs:
            unsub()
        self._unsubs = []

    # -------------------------------------------------------------- handlers
    def _on_admission(self, evt: AdmissionDecision) -> None:
        if evt.decision != "admit" or evt.rid is None:
            return
        # a re-admission after preemption re-opens the same rid's span;
        # the earlier open segment is flushed as its own completed span
        prior = self._open.pop(evt.rid, None)
        if prior is not None:
            self._close_root(prior, self._now_us(), {"resumed": True})
        self._open[evt.rid] = {
            "ts": self._now_us(),
            "rid": evt.rid,
            "args": {"queue_depth": evt.queue_depth,
                     "window_blocks": evt.window_blocks,
                     "policy": evt.policy,
                     "tenant": evt.tenant},
        }

    def _close_root(self, span: dict, end_us: float,
                    extra: "dict | None" = None) -> None:
        args = dict(span["args"])
        if extra:
            args.update(extra)
        self.events.append({
            "name": f"request {span['rid']}",
            "cat": "request",
            "ph": "X",
            "ts": span["ts"],
            "dur": max(0.0, end_us - span["ts"]),
            "pid": self.pid,
            "tid": TID_REQUEST_BASE + span["rid"],
            "args": args,
        })

    def _on_completed(self, evt: RequestCompleted) -> None:
        span = self._open.pop(evt.rid, None)
        if span is None:
            return                       # admitted before the collector
        self._close_root(span, self._now_us(),
                         {"n_tokens": evt.n_tokens, "end_step": evt.step})

    def _on_chunk(self, evt: PrefillChunkDone) -> None:
        self.events.append({
            "name": "prefill_chunk",
            "cat": "prefill",
            "ph": "X",
            "ts": self._now_us(),
            "dur": 0.0,
            "pid": self.pid,
            "tid": TID_REQUEST_BASE + evt.rid,
            "args": {"rid": evt.rid, "start": evt.start, "end": evt.end,
                     "step": evt.step},
        })

    def _on_step(self, evt: StepCompleted) -> None:
        now = self._now_us()
        dur = max(0.0, evt.wall_s * 1e6)
        self.events.append({
            "name": "engine.step",
            "cat": "engine",
            "ph": "X",
            "ts": now - dur,             # fences during the step nest inside
            "dur": dur,
            "pid": self.pid,
            "tid": TID_ENGINE,
            "args": {"step": evt.step, "tokens": evt.tokens,
                     "running": evt.running},
        })

    def _on_fence(self, evt: FenceIssued) -> None:
        self.events.append({
            "name": "fence",
            "cat": "coherence",
            "ph": "X",
            "ts": self._now_us(),
            "dur": 0.0,
            "pid": self.pid,
            "tid": TID_ENGINE,
            "args": {"reason": evt.reason, "n_blocks": evt.n_blocks,
                     "scoped": evt.scoped, "seq": evt.seq,
                     "workers": (None if evt.workers is None
                                 else list(evt.workers))},
        })

    def _on_refresh(self, evt: ShardRefreshed) -> None:
        self.events.append({
            "name": "shard_refresh",
            "cat": "coherence",
            "ph": "X",
            "ts": self._now_us(),
            "dur": 0.0,
            "pid": self.pid,
            "tid": TID_ENGINE,
            "args": {"reason": evt.reason, "shards": list(evt.shards),
                     "entries": evt.entries, "nbytes": evt.nbytes,
                     "full": evt.full},
        })

    def _on_preempt(self, evt: PreemptionResolved) -> None:
        self.events.append({
            "name": "preemption",
            "cat": "admission",
            "ph": "i",
            "s": "p",
            "ts": self._now_us(),
            "pid": self.pid,
            "tid": TID_ENGINE,
            "args": {"rid": evt.rid, "strategy": evt.strategy},
        })

    def _on_reshard(self, evt: TopologyChanged) -> None:
        self.events.append({
            "name": "reshard",
            "cat": "topology",
            "ph": "i",
            "s": "g",
            "ts": self._now_us(),
            "pid": self.pid,
            "tid": TID_ENGINE,
            "args": {"old": evt.old_num_workers,
                     "new": evt.new_num_workers,
                     "moved_slots": list(evt.moved_slots)},
        })

    # ---------------------------------------------------------------- export
    def root_spans(self) -> list[dict]:
        """The closed per-request root spans, admission order."""
        return sorted((e for e in self.events if e["cat"] == "request"),
                      key=lambda e: e["ts"])

    @property
    def open_spans(self) -> dict:
        """rid → still-open root span (admitted, not yet completed)."""
        return dict(self._open)

    def summary(self) -> dict:
        """Artifact-friendly counts (what ``benchmarks/validate.py``
        checks on the loadgen trace)."""
        by_cat: dict[str, int] = {}
        for e in self.events:
            by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + 1
        return {
            "events": len(self.events),
            "root_spans": len(self.root_spans()),
            "open_spans": len(self._open),
            "by_cat": by_cat,
        }

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON payload (metadata + events)."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": self.pid,
             "args": {"name": "repro-fpr engine"}},
            {"name": "thread_name", "ph": "M", "pid": self.pid,
             "tid": TID_ENGINE, "args": {"name": "engine/coherence"}},
        ]
        rids = sorted({e["tid"] - TID_REQUEST_BASE
                       for e in self.events
                       if e["tid"] >= TID_REQUEST_BASE})
        meta += [{"name": "thread_name", "ph": "M", "pid": self.pid,
                  "tid": TID_REQUEST_BASE + rid,
                  "args": {"name": f"request {rid}"}} for rid in rids]
        return {"traceEvents": meta + sorted(self.events,
                                             key=lambda e: e["ts"]),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return path


__all__ = ["TID_ENGINE", "TID_REQUEST_BASE", "TraceCollector"]
