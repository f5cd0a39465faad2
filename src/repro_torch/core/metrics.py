"""Namespaced metrics registry — one flat snapshot schema for the stack.

Before this module the repro had three disjoint counter systems:
``FprStats`` (allocation-phase counters), ``FenceStats`` (fence engine
totals) and the ad-hoc dict merging in ``Engine.stats()`` /
``PagedKVCache.counters()``.  Every consumer — tests, benchmark artifacts,
the CI smoke lane — picked keys out of a differently shaped nested dict.

The :class:`MetricsRegistry` replaces that with one contract:

  * subsystems **register a namespace** (``fpr``, ``fence``, ``table``,
    ``device``, ``admission``, ``engine``) with a zero-arg source callable
    returning their counters (nested dicts allowed);
  * :meth:`MetricsRegistry.snapshot` returns a single **flat** dict whose
    keys are dot-joined paths (``fence.fences``, ``device.refreshed_bytes``,
    ``admission.ledger.peak_committed`` …) — the *only* schema artifacts
    and dashboards should consume;
  * the stable key set is pinned in :data:`STABLE_SCHEMA`; dynamic groups
    (per-reason fence counts, per-worker epochs) are declared as
    :data:`WILDCARD_PREFIXES` so schema validation can tell drift from
    legitimate per-config variation.

Namespaces may be dotted (``fpr.eviction``) to nest a subsystem's
counters under an existing family without routing them through its
source callable — the watermark daemon registers itself that way.

The pre-registry nested views (``Engine.stats()`` /
``FprMemoryManager.counters()`` and the ``legacy_view`` adapter behind
them) completed their one-release deprecation window and are gone; the
flat snapshot is the only counter surface.
"""

from __future__ import annotations

from bisect import bisect_left
from collections import Counter
from typing import Callable, Iterable

Source = Callable[[], dict]

#: canonical namespaces, in emission order (dotted entries are nested
#: subsystem registrations — their keys live under the parent family)
NAMESPACES = ("fpr", "fpr.prefix", "fpr.eviction", "fence", "table",
              "device", "admission", "engine")

#: flat-key groups whose *members* are config-dependent (fence reasons seen,
#: one epoch per worker, one ledger share per worker) — validated by prefix
WILDCARD_PREFIXES = (
    "fence.by_reason.",
    "fence.island_epochs.",
    "fence.worker_epochs.",
)

#: the stable flat-snapshot contract of a full Engine stack.  The golden
#: schema test (tests/test_metrics.py) pins a live snapshot against this;
#: benchmarks/validate.py checks the CI smoke artifacts against it.
STABLE_SCHEMA = (
    # fpr.* — FprStats, the §IV-A allocation-phase counters
    "fpr.allocs",
    "fpr.clean_allocs",
    "fpr.context_exits",
    "fpr.faults",
    "fpr.frees",
    "fpr.recycled_hits",
    "fpr.swap_ins",
    "fpr.swap_outs",
    # fpr.prefix.* — prefix-sharing index counters (manager-owned; present
    # on bare managers too).  in_set_violations is an invariant witness:
    # it stays 0 for as long as no refcounted block ever reaches the
    # allocator — the "zero fences inside a sharing set" guarantee.
    "fpr.prefix.cow_copies",
    "fpr.prefix.evict_pinned",
    "fpr.prefix.exit_elided",
    "fpr.prefix.exit_fenced",
    "fpr.prefix.hit_blocks",
    "fpr.prefix.hit_rate",
    "fpr.prefix.in_set_violations",
    "fpr.prefix.indexed_live",
    "fpr.prefix.lookups",
    "fpr.prefix.miss_blocks",
    "fpr.prefix.orphaned_live",
    "fpr.prefix.shared_detaches",
    "fpr.prefix.sharing_exits",
    # fpr.eviction.* — watermark-daemon pass counters (engine stacks; a
    # bare FprMemoryManager has no daemon and omits the group)
    "fpr.eviction.deferred",
    "fpr.eviction.pages_dropped",
    "fpr.eviction.pages_scanned",
    "fpr.eviction.passes_huge",
    "fpr.eviction.passes_normal",
    "fpr.eviction.swap_outs",
    "fpr.eviction.wakeups",
    # fence.* — FenceStats via FenceEngine.totals()
    "fence.elided_by_scope",
    "fence.elided_by_version",
    "fence.fences",
    "fence.fences_averted",
    "fence.fences_scoped",
    "fence.measured_s",
    "fence.modeled_s",
    "fence.replicas_spared",
    "fence.skipped_at_free",
    "fence.workers_covered",
    # table.* — host-side BlockTableStore epochs/diagnostics
    "table.epoch",
    "table.num_shards",
    "table.reshards",
    "table.shard_epochs",
    "table.shard_overflows",
    "table.stale_lookups_detected",
    # device.* — PagedKVCache fence-refresh + topology counters
    "device.fence_drains",
    "device.full_refreshes",
    "device.refreshed_bytes",
    "device.refreshed_entries",
    "device.reshard_moved_entries",
    "device.reshard_refreshed_bytes",
    "device.reshards",
    "device.shard_refreshes",
    "device.step_upload_entries",
    "device.table_shards",
    # engine.* — serving-loop counters
    "engine.completed",
    "engine.demand_pager_gave_up",
    "engine.num_workers",
    # engine.obs.* — observability-plane self-accounting: subscriber
    # exceptions the EventBus isolated (dropped deliveries, never a
    # crashed publish)
    "engine.obs.subscriber_errors",
    "engine.prefill_chunk_traces",
    "engine.prefill_chunks",
    "engine.prefill_traces",
    "engine.steps",
    "engine.tokens",
    "engine.tokens_per_s",
    "engine.wall_s",
    # admission.* — governor + ledger (enabled=False collapses to one key)
    "admission.enabled",
)

#: island-topology keys, present only when a multi-island
#: :class:`~repro_torch.core.topology.Topology` is installed.  Kept out of
#: :data:`STABLE_SCHEMA` so flat single-island snapshots stay bit for bit
#: identical to the pre-island contract (the golden tests pin exact
#: equality); schema validation still admits them.
ISLAND_SCHEMA = (
    # fence.island.* — two-level FenceEngine accounting
    "fence.island.deltas_propagated",
    "fence.island.fences_cross",
    "fence.island.fences_intra",
    "fence.island.modeled_cross_s",
    "fence.island.modeled_intra_s",
    "fence.island.num_islands",
    # table.island.* — per-island replica-group bump classification
    "table.island.fences_cross",
    "table.island.fences_intra",
    "table.island.shard_bumps_intra",
    "table.island.shard_bumps_remote",
    # device.island.* — delta propagation to remote-island replicas
    "device.island.delta_bytes",
    "device.island.delta_entries",
    "device.island.intra_refreshes",
    "device.island.remote_deltas",
    # admission — per-island committed-block shares
    "admission.ledger.per_island_committed",
)

#: ragged-kernel keys, present only when the engine serves mixed
#: prefill + decode batches through the single ragged fused-KV kernel
#: (``EngineConfig(ragged_kernel=True)``).  Like :data:`ISLAND_SCHEMA`,
#: kept out of :data:`STABLE_SCHEMA` so default engines snapshot bit for
#: bit as before; schema validation still admits the group.
KERNEL_SCHEMA = (
    # fused-KV bytes the step's page walks moved (one DMA per block)
    "engine.kernel.dma_bytes",
    # pallas kernel launches — under the ragged path exactly one per
    # attention layer per engine step, whatever the prefill/decode mix
    "engine.kernel.kernel_calls",
    # revolving-buffer depth the autotune cache chose for this shape
    "engine.kernel.pipeline_depth",
    # engine steps served by the single ragged call
    "engine.kernel.ragged_steps",
)

#: admission.* keys present only when a MemoryGovernor is attached
ADMISSION_SCHEMA = (
    "admission.admitted",
    "admission.affinity_hit_rate",
    "admission.affinity_hits",
    "admission.affinity_misses",
    "admission.chunk_grows",
    "admission.holds",
    "admission.ledger.capacity",
    "admission.ledger.committed",
    "admission.ledger.limit",
    "admission.ledger.peak_committed",
    "admission.ledger.per_worker_committed",
    "admission.policy",
    "admission.preempt_strategy",
    "admission.preemptions_recompute",
    "admission.preemptions_swap",
    "admission.quota.enabled",
    "admission.quota.rejections",
    "admission.quota.tenants",
    "admission.rejected_overcommit",
)


# --------------------------------------------------------------- metric kinds
#: exporter-facing metric kinds.  ``counter`` is monotonically
#: non-decreasing over one registry's lifetime, ``gauge`` is a level /
#: ratio that moves both ways, ``info`` is a string rendered as a
#: constant-1 sample with a ``value`` label, ``histogram`` is a
#: fixed-bucket :class:`Histogram`.
KINDS = ("counter", "gauge", "info", "histogram")

#: metric kind per schema key.  The golden test
#: (tests/test_metrics.py::TestKinds) asserts every STABLE_SCHEMA /
#: ADMISSION_SCHEMA key appears here — a new counter cannot land without
#: declaring what it *is*, which is what keeps ratios (``fpr.prefix.
#: hit_rate``) from silently exporting as monotonic counters.
SCHEMA_KINDS = {
    # fpr.* — §IV-A allocation-phase event totals
    "fpr.allocs": "counter",
    "fpr.clean_allocs": "counter",
    "fpr.context_exits": "counter",
    "fpr.faults": "counter",
    "fpr.frees": "counter",
    "fpr.recycled_hits": "counter",
    "fpr.swap_ins": "counter",
    "fpr.swap_outs": "counter",
    # fpr.prefix.* — mostly totals; the live-set sizes and the hit *rate*
    # are levels (the historic kind confusion this table fixes)
    "fpr.prefix.cow_copies": "counter",
    "fpr.prefix.evict_pinned": "counter",
    "fpr.prefix.exit_elided": "counter",
    "fpr.prefix.exit_fenced": "counter",
    "fpr.prefix.hit_blocks": "counter",
    "fpr.prefix.hit_rate": "gauge",
    "fpr.prefix.in_set_violations": "counter",
    "fpr.prefix.indexed_live": "gauge",
    "fpr.prefix.lookups": "counter",
    "fpr.prefix.miss_blocks": "counter",
    "fpr.prefix.orphaned_live": "gauge",
    "fpr.prefix.shared_detaches": "counter",
    "fpr.prefix.sharing_exits": "counter",
    # fpr.eviction.* — watermark-daemon pass totals
    "fpr.eviction.deferred": "counter",
    "fpr.eviction.pages_dropped": "counter",
    "fpr.eviction.pages_scanned": "counter",
    "fpr.eviction.passes_huge": "counter",
    "fpr.eviction.passes_normal": "counter",
    "fpr.eviction.swap_outs": "counter",
    "fpr.eviction.wakeups": "counter",
    # fence.* — shootdown totals (the measured/modeled seconds accumulate)
    "fence.elided_by_scope": "counter",
    "fence.elided_by_version": "counter",
    "fence.fences": "counter",
    "fence.fences_averted": "counter",
    "fence.fences_scoped": "counter",
    "fence.measured_s": "counter",
    "fence.modeled_s": "counter",
    "fence.replicas_spared": "counter",
    "fence.skipped_at_free": "counter",
    "fence.workers_covered": "counter",
    # table.* — epochs only grow; shard counts are topology levels
    "table.epoch": "counter",
    "table.num_shards": "gauge",
    "table.reshards": "counter",
    "table.shard_epochs": "counter",
    "table.shard_overflows": "counter",
    "table.stale_lookups_detected": "counter",
    # device.*
    "device.fence_drains": "counter",
    "device.full_refreshes": "counter",
    "device.refreshed_bytes": "counter",
    "device.refreshed_entries": "counter",
    "device.reshard_moved_entries": "counter",
    "device.reshard_refreshed_bytes": "counter",
    "device.reshards": "counter",
    "device.shard_refreshes": "counter",
    "device.step_upload_entries": "counter",
    "device.table_shards": "gauge",
    # engine.*
    "engine.completed": "counter",
    "engine.demand_pager_gave_up": "counter",
    "engine.num_workers": "gauge",
    "engine.obs.subscriber_errors": "counter",
    "engine.prefill_chunk_traces": "counter",
    "engine.prefill_chunks": "counter",
    "engine.prefill_traces": "counter",
    "engine.steps": "counter",
    "engine.tokens": "counter",
    "engine.tokens_per_s": "gauge",
    "engine.wall_s": "counter",
    # admission.*
    "admission.enabled": "gauge",
    "admission.admitted": "counter",
    "admission.affinity_hit_rate": "gauge",
    "admission.affinity_hits": "counter",
    "admission.affinity_misses": "counter",
    "admission.chunk_grows": "counter",
    "admission.holds": "counter",
    "admission.ledger.capacity": "gauge",
    "admission.ledger.committed": "gauge",
    "admission.ledger.limit": "gauge",
    "admission.ledger.peak_committed": "gauge",
    "admission.ledger.per_worker_committed": "gauge",
    "admission.policy": "info",
    "admission.preempt_strategy": "info",
    "admission.preemptions_recompute": "counter",
    "admission.preemptions_swap": "counter",
    "admission.quota.enabled": "gauge",
    "admission.quota.rejections": "counter",
    "admission.quota.tenants": "gauge",
    "admission.rejected_overcommit": "counter",
    # island.* groups (multi-island topologies only)
    "fence.island.deltas_propagated": "counter",
    "fence.island.fences_cross": "counter",
    "fence.island.fences_intra": "counter",
    "fence.island.modeled_cross_s": "counter",
    "fence.island.modeled_intra_s": "counter",
    "fence.island.num_islands": "gauge",
    "table.island.fences_cross": "counter",
    "table.island.fences_intra": "counter",
    "table.island.shard_bumps_intra": "counter",
    "table.island.shard_bumps_remote": "counter",
    "device.island.delta_bytes": "counter",
    "device.island.delta_entries": "counter",
    "device.island.intra_refreshes": "counter",
    "device.island.remote_deltas": "counter",
    "admission.ledger.per_island_committed": "gauge",
    # engine.kernel.* (ragged fused-KV serving only)
    "engine.kernel.dma_bytes": "counter",
    "engine.kernel.kernel_calls": "counter",
    "engine.kernel.pipeline_depth": "gauge",
    "engine.kernel.ragged_steps": "counter",
}

#: kind per wildcard group (per-reason fence totals and per-worker fence
#: epochs are both monotonic)
WILDCARD_KINDS = {
    "fence.by_reason.": "counter",
    "fence.island_epochs.": "counter",
    "fence.worker_epochs.": "counter",
}

# ----------------------------------------------------------------- histograms
#: the pinned histogram set: name → ascending finite bucket upper bounds
#: (an implicit +Inf overflow bucket completes each).  Like
#: :data:`STABLE_SCHEMA`, membership is the contract —
#: :meth:`MetricsRegistry.histogram` refuses unpinned names, so a
#: dashboard's bucket layout can never drift silently.
HISTOGRAM_SCHEMA = {
    # wall seconds of one Engine.step (admit + paging + chunks + decode)
    "engine.obs.step_latency_s": (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
    # engine steps a request waited between submit and seating (the
    # deterministic virtual-time queue-wait; 0 = admitted the same step)
    "engine.obs.queue_wait_steps": (
        0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
    # queue depth the governor saw at each admission round
    "admission.obs.queue_depth": (0, 1, 2, 4, 8, 16, 32, 64, 128),
    # workers covered per fence — the scope popcount the paper's scoped
    # shootdown pays instead of a broadcast (global fences observe the
    # full worker count)
    "fence.obs.scope_workers": (1, 2, 4, 8, 16, 32, 64),
    # bytes one fence's device-shard refresh re-uploaded
    "device.obs.refresh_bytes": (
        256, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304),
}

#: flat sub-keys each histogram contributes to the snapshot
HISTOGRAM_FIELDS = ("buckets", "count", "p50", "p99", "sum")


def histogram_keys(names: Iterable[str] = ()) -> tuple:
    """The flat snapshot keys of ``names`` (default: every pinned
    histogram) — what the golden schema test unions into the contract."""
    names = tuple(names) or tuple(HISTOGRAM_SCHEMA)
    return tuple(f"{n}.{f}" for n in sorted(names)
                 for f in HISTOGRAM_FIELDS)


class Histogram:
    """Fixed-bucket latency/size histogram with interpolated percentiles.

    ``bounds`` are ascending finite upper bucket edges; observations above
    the last edge land in an implicit +Inf overflow bucket.  Percentiles
    interpolate linearly inside the winning bucket (the overflow bucket
    clamps to the last finite edge), matching how a Prometheus server
    evaluates ``histogram_quantile`` over the same buckets.
    """

    __slots__ = ("name", "bounds", "counts", "sum", "count", "exemplars")

    def __init__(self, name: str, bounds: Iterable[float]):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        if not self.bounds or any(a >= b for a, b in zip(self.bounds,
                                                         self.bounds[1:])):
            raise ValueError(f"histogram {name!r} bounds must be "
                             f"non-empty and strictly ascending")
        self.counts = [0] * (len(self.bounds) + 1)   # +1: +Inf overflow
        self.sum = 0.0
        self.count = 0
        # per-bucket most-recent exemplar: (trace_id, value) or None.
        # Kept out of snapshot() — HISTOGRAM_FIELDS is pinned; the
        # OpenMetrics exporter (core/export.py) renders them inline.
        self.exemplars: list = [None] * (len(self.bounds) + 1)

    def observe(self, value: float,
                exemplar: "str | None" = None) -> None:
        value = float(value)
        i = bisect_left(self.bounds, value)
        self.counts[i] += 1
        if exemplar is not None:
            self.exemplars[i] = (str(exemplar), value)
        self.sum += value
        self.count += 1

    def percentile(self, q: float) -> "float | None":
        """Interpolated ``q``-th percentile (``None`` on an empty
        histogram)."""
        if not self.count:
            return None
        target = (q / 100.0) * self.count
        seen = 0
        for i, n in enumerate(self.counts):
            if not n:
                continue
            if seen + n >= target:
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1])
                lo = self.bounds[i - 1] if i > 0 else 0.0
                if i >= len(self.bounds):        # overflow: clamp
                    return hi
                return lo + (hi - lo) * max(0.0, target - seen) / n
            seen += n
        return self.bounds[-1]

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.exemplars = [None] * (len(self.bounds) + 1)

    def snapshot(self) -> dict:
        """Flat-snapshot leaf view (JSON scalars/lists only)."""
        return {
            "buckets": list(self.counts),
            "count": self.count,
            "p50": self.percentile(50.0),
            "p99": self.percentile(99.0),
            "sum": round(self.sum, 9),
        }


def kind_of(key: str) -> "str | None":
    """Metric kind of a flat snapshot key, ``None`` when unknown.

    Histogram sub-keys (``<name>.count`` …) resolve to ``histogram``;
    wildcard-group members resolve through :data:`WILDCARD_KINDS`.
    """
    k = SCHEMA_KINDS.get(key)
    if k is not None:
        return k
    for name in HISTOGRAM_SCHEMA:
        if key == name or key.startswith(name + "."):
            return "histogram"
    for prefix, k in WILDCARD_KINDS.items():
        if key.startswith(prefix):
            return k
    return None


def flatten(tree: dict, prefix: str = "") -> dict:
    """Dot-join a nested counter dict.  Dicts/Counters recurse; scalars,
    strings, ``None`` and lists/tuples (kept as JSON-able leaves, e.g.
    per-shard epoch vectors) terminate."""
    flat: dict = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, (dict, Counter)):
            flat.update(flatten(value, prefix=f"{path}."))
        elif isinstance(value, (list, tuple)):
            flat[path] = list(value)
        else:
            flat[path] = value
    return flat


class MetricsRegistry:
    """Namespace → source registry producing the unified flat snapshot."""

    def __init__(self) -> None:
        self._sources: dict[str, Source] = {}
        self._histograms: dict[str, Histogram] = {}

    def register(self, namespace: str, source: Source) -> None:
        """Attach ``source`` (a zero-arg callable returning a dict) under
        ``namespace``.  Re-registering a namespace replaces its source —
        the stack rebuilds registries on reconfiguration.  Dotted
        namespaces (``fpr.eviction``) nest a subsystem under an existing
        family."""
        if not all(seg.isidentifier() for seg in namespace.split(".")):
            raise ValueError(f"namespace segments must be identifiers, "
                             f"got {namespace!r}")
        self._sources[namespace] = source

    def unregister(self, namespace: str) -> None:
        self._sources.pop(namespace, None)

    @property
    def namespaces(self) -> tuple:
        return tuple(self._sources)

    # ------------------------------------------------------------ histograms
    def histogram(self, name: str) -> Histogram:
        """The registry's :class:`Histogram` for ``name``, created on
        first use with the :data:`HISTOGRAM_SCHEMA`-pinned buckets.
        Unpinned names are refused — histograms are schema artifacts, not
        ad-hoc accumulators."""
        hist = self._histograms.get(name)
        if hist is None:
            bounds = HISTOGRAM_SCHEMA.get(name)
            if bounds is None:
                raise ValueError(
                    f"histogram {name!r} is not pinned in HISTOGRAM_SCHEMA; "
                    f"known: {sorted(HISTOGRAM_SCHEMA)}")
            hist = self._histograms[name] = Histogram(name, bounds)
        return hist

    @property
    def histograms(self) -> dict:
        return dict(self._histograms)

    def snapshot(self) -> dict:
        """The unified flat snapshot: ``{"ns.path.key": value}``, sorted
        within the canonical namespace order.  Histograms contribute their
        :data:`HISTOGRAM_FIELDS` leaves after the counter namespaces."""
        flat: dict = {}
        ordered = [ns for ns in NAMESPACES if ns in self._sources]
        ordered += [ns for ns in self._sources if ns not in NAMESPACES]
        for ns in ordered:
            tree = self._sources[ns]()
            part = flatten(tree, prefix=f"{ns}.")
            flat.update({k: part[k] for k in sorted(part)})
        for name in sorted(self._histograms):
            flat.update(flatten(self._histograms[name].snapshot(),
                                prefix=f"{name}."))
        return flat

    def schema(self) -> tuple:
        """The current snapshot's key set (values discarded)."""
        return tuple(self.snapshot())


def schema_violations(keys: Iterable[str], *,
                      stable: Iterable[str] = STABLE_SCHEMA,
                      admission: Iterable[str] = ADMISSION_SCHEMA,
                      island: Iterable[str] = ISLAND_SCHEMA,
                      kernel: Iterable[str] = KERNEL_SCHEMA,
                      wildcards: Iterable[str] = WILDCARD_PREFIXES
                      ) -> list[str]:
    """Namespaced keys in ``keys`` that the schema does not know.

    Only dotted keys whose first segment is a canonical namespace are
    checked — artifact-local fields (``seed``, ``tokens_identical`` …)
    pass through untouched.
    """
    known = set(stable) | set(admission) | set(island) | set(kernel)
    hist_prefixes = tuple(f"{n}." for n in HISTOGRAM_SCHEMA)
    bad = []
    for key in keys:
        ns = key.split(".", 1)[0]
        if ns not in NAMESPACES:
            continue
        if key in known or any(key.startswith(w) for w in wildcards):
            continue
        if key in HISTOGRAM_SCHEMA or any(key.startswith(h)
                                          for h in hist_prefixes):
            continue
        bad.append(key)
    return sorted(bad)


__all__ = ["ADMISSION_SCHEMA", "HISTOGRAM_FIELDS", "HISTOGRAM_SCHEMA",
           "Histogram", "ISLAND_SCHEMA", "KERNEL_SCHEMA", "KINDS",
           "MetricsRegistry",
           "NAMESPACES", "SCHEMA_KINDS", "STABLE_SCHEMA", "WILDCARD_KINDS",
           "WILDCARD_PREFIXES", "flatten", "histogram_keys", "kind_of",
           "schema_violations"]
