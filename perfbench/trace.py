"""The traced run's instruments, set from the benchmark alone.

:class:`Tracer` patches attributes around the calls into each layer of
the port (no program file changes): ``Engine.step``, the admission and
residency passes, ``PagedKVCache.update_tables``, the model entry points
of ``models/transformer.py`` and the MoE FFN.  Each gets a
``record_function`` range, which names what the host was doing in the
profiler's trace; while recording, the entry points and the MoE FFN of a
decode step also get a pair of CUDA events (which neither block the host
nor change the run), and while profiling the tables, lengths and ragged
descriptors each kernel call reads are kept for the kernels' work.

:func:`reduce` turns the profiler's events into the device's busy time,
the kernels' time by name and the idle gaps by the host's activity.
"""

from __future__ import annotations

import json
import re
import time
from contextlib import ExitStack
from pathlib import Path

import numpy as np

ENTRY_POINTS = ("prefill", "prefill_chunk", "decode_step", "ragged_step")
#: Chrome-trace categories of the device's operations and of the host's
#: ranges (``record_function``)
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION = "user_annotation"
LAUNCHES = ("cuda_runtime", "cuda_driver")
#: the host range around a kernel's wrapper: ``kernel.<work module>``
KERNEL = "kernel."
WINDOW = "perfbench.window"
#: what the host is doing outside every range: the benchmark's client
#: loop (submits, bookkeeping) between steps
OUTSIDE = "benchmark loop (between steps)"


class HostEvent:
    """A stand-in for ``torch.cuda.Event`` off the card (CPU tests): the
    host clock at ``record``."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Tracer:
    def __init__(self, torch):
        self.torch = torch
        self.cuda = torch.cuda.is_available()
        self.on = False          # recording spans (the measured window)
        self.profiling = False   # the profiler's sub-window
        self.spans = {name: [] for name in ENTRY_POINTS}
        self.steps: list = []    # (host s, [event pairs]) per Engine.step
        self.prefill_tokens: list = []
        self.moe_per_decode: list = []
        self.decode_calls: list = []   # (tables, lengths) per decode_step
        self.ragged_calls: list = []   # descriptor per ragged_step
        self._cur: list = []
        self._moe = None
        self._tables = None
        self._desc = None
        self._stack = ExitStack()
        self.prof = None
        self._window = None

    # ------------------------------------------------------------ patches
    def _patch(self, owner, name, make):
        inner = getattr(owner, name)
        self._stack.callback(setattr, owner, name, inner)
        setattr(owner, name, make(inner))

    def _ranged(self, label):
        rf = self.torch.profiler.record_function

        def make(inner):
            def call(*a, **k):
                with rf(label):
                    return inner(*a, **k)
            return call
        return make

    def _events(self):
        ev = self.torch.cuda.Event if self.cuda else HostEvent
        return ev(enable_timing=True), ev(enable_timing=True)

    def install(self) -> None:
        from repro_torch.kernels.paged_attention import ops as pa_ops
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import transformer as tfm
        from repro_torch.serving.engine import Engine
        from repro_torch.serving.kv_cache import PagedKVCache
        rf = self.torch.profiler.record_function
        tr = self

        def step(inner):
            def call(eng):
                tr._cur = []
                t0 = time.perf_counter()
                with rf("engine.step"):
                    out = inner(eng)
                if tr.on:
                    tr.steps.append((time.perf_counter() - t0, tr._cur))
                return out
            return call

        def entry(name):
            def make(inner):
                def call(*a, **k):
                    with rf(name):
                        if not tr.on:
                            return inner(*a, **k)
                        if tr.profiling:
                            if name == "decode_step":
                                tr.decode_calls.append(tr._tables)
                            elif name == "ragged_step":
                                tr.ragged_calls.append(tr._desc)
                        if name == "decode_step":
                            tr._moe = []
                        s, e = tr._events()
                        s.record()
                        out = inner(*a, **k)
                        e.record()
                    tr.spans[name].append((s, e))
                    tr._cur.append((s, e))
                    if name == "decode_step":
                        tr.moe_per_decode.append(tr._moe)
                        tr._moe = None
                    return out
                return call
            return make

        def moe(inner):
            def call(*a, **k):
                with rf("moe_ffn"):
                    if tr._moe is None:
                        return inner(*a, **k)
                    s, e = tr._events()
                    s.record()
                    out = inner(*a, **k)
                    e.record()
                tr._moe.append((s, e))
                return out
            return call

        def prefill_request(inner):
            def call(eng, r):
                if tr.on:
                    tr.prefill_tokens.append(len(r.prompt))
                return inner(eng, r)
            return call

        def update_tables(inner):
            def call(cache, mappings, lengths):
                with rf("update_tables"):
                    out = inner(cache, mappings, lengths)
                if tr.profiling:
                    tr._tables = (cache._host_tables.copy(),
                                  np.array(lengths, copy=True))
                return out
            return call

        def descriptor(inner):
            def call(*a, **k):
                d = inner(*a, **k)
                if tr.profiling:
                    tr._desc = {key: d[key].copy() for key in
                                ("token_row", "token_pos", "kv_lens")}
                return d
            return call

        self._patch(Engine, "step", step)
        self._patch(Engine, "_admit", self._ranged("admission"))
        self._patch(Engine, "_settle_residency",
                    self._ranged("residency settle"))
        self._patch(Engine, "_prefill_request", prefill_request)
        self._patch(Engine, "submit", self._ranged("submit"))
        self._patch(PagedKVCache, "update_tables", update_tables)
        self._patch(pa_ops, "build_ragged_descriptor", descriptor)
        self._patch(moe_mod, "moe_ffn", moe)
        for name in ENTRY_POINTS:
            self._patch(tfm, name, entry(name))
        import importlib

        from perfbench import work
        for k in work.kernels():
            mod, attr = importlib.import_module(f"perfbench.work.{k}").WRAPS
            self._patch(importlib.import_module(mod), attr,
                        self._ranged(KERNEL + k))

    def uninstall(self) -> None:
        self._stack.close()

    # ----------------------------------------------------------- profiler
    def start_profile(self) -> None:
        prof = self.torch.profiler
        acts = [prof.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(prof.ProfilerActivity.CUDA)
        self.prof = prof.profile(activities=acts)
        self.prof.__enter__()
        self._window = prof.record_function(WINDOW)
        self._window.__enter__()
        self.profiling = True

    def stop_profile(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.profiling = False

    def profile_events(self, path) -> list:
        """(kind, name, start_ns, end_ns, correlation) of every event the
        profiler kept: ``annotation`` for the host's ranges, ``launch``
        for the host's launch calls, ``device`` for the device's
        operations (a launch and the operation it started share a
        correlation).  Read from the profiler's Chrome trace, written to
        ``path`` and deleted after."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        out = []
        for e in events:
            cat = e.get("cat")
            kind = ("annotation" if cat == ANNOTATION else
                    "device" if cat in DEVICE_KINDS else
                    "launch" if cat in LAUNCHES else None)
            if e.get("ph") != "X" or kind is None:
                continue
            s0 = int(round(float(e["ts"]) * 1e3))
            s1 = s0 + int(round(float(e.get("dur", 0)) * 1e3))
            corr = (e.get("args") or {}).get("correlation")
            out.append((kind, e.get("name", ""), s0, s1, corr))
        return out

    # ------------------------------------------------------------ reading
    def span_ms(self, pairs) -> float:
        return sum(s.elapsed_time(e) for s, e in pairs)


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without its return type and parameter
    list (template arguments kept)."""
    n = re.sub(r"^void\s+", "", name)
    depth = 0
    for i, ch in enumerate(n):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            n = n[:i]
            break
    return n[:width]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ranges, starts, t):
    """The innermost of ``ranges`` (sorted (start, end, name), nested)
    open at ``t``, or None."""
    i = int(np.searchsorted(starts, t, side="right"))
    for s, e, n in reversed(ranges[max(0, i - 64):i]):
        if e > t:
            return n
    return None


def reduce(events) -> dict:
    """The traced window's figures from (kind, name, start_ns, end_ns,
    correlation) events: ``window_s`` (the ``perfbench.window`` range),
    ``busy_s`` (the union of device operations inside it), ``kernels``
    (seconds by short name), ``kernel_time`` (seconds by ``kernel.<name>``
    range: the device operations whose launch the host made inside that
    range) and ``idle_gaps`` (idle seconds by the innermost host range
    open when each gap began)."""
    win = [(s, e) for k, n, s, e, _ in events
           if k == "annotation" and n == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = win[0]
    ann = sorted(((s, e, n) for k, n, s, e, _ in events
                  if k == "annotation" and n != WINDOW),
                 key=lambda a: (a[0], -a[1]))
    starts = np.array([a[0] for a in ann], dtype=np.int64)
    kr = [a for a in ann if a[2].startswith(KERNEL)]
    kstarts = np.array([a[0] for a in kr], dtype=np.int64)
    launched = {c: s for k, n, s, e, c in events
                if k == "launch" and c is not None}
    dev = [(max(s, w0), min(e, w1), n, c) for k, n, s, e, c in events
           if k == "device" and e > w0 and s < w1]
    kernels: dict = {}
    ktime: dict = {}
    for s, e, n, c in dev:
        kernels[short_name(n)] = kernels.get(short_name(n), 0.0) \
            + (e - s) / 1e9
        label = _innermost(kr, kstarts, launched[c]) \
            if c in launched else None
        if label is not None:
            key = label[len(KERNEL):]
            ktime[key] = ktime.get(key, 0.0) + (e - s) / 1e9
    busy = _merge([(s, e) for s, e, _, _ in dev])
    gaps = []
    t = w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    idle: dict = {}
    for g0, g1 in gaps:
        label = _innermost(ann, starts, g0) or OUTSIDE
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    return {"window_s": (w1 - w0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "kernels": kernels, "kernel_time": ktime, "idle_gaps": idle}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
