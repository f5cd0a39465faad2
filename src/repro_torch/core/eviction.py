"""Watermark eviction daemon — the paper's §IV-B kswapd adaptation.

Stock Linux (baseline): kswapd wakes when free memory drops below the *low*
watermark and evicts LRU batches of 32 pages (one shootdown per batch) until
free memory reaches the *high* watermark.

FPR (§IV-B): pages in a recycling context are **exempt** while free memory is
between *min* and *low*.  Only when free memory hits *min* does the daemon
build one **huge batch** — enough to climb back to *high* — and send a
**single merged fence** for all of it.  Version stamping before that fence
makes every evicted block's later context-exit allocation fence-free (§IV-C5).

Every completed pass is published as a
:class:`~repro_torch.core.events.EvictionPass` event on the manager's bus
(pages scanned / dropped / deferred, free-block levels), and the pass
counters are exposed for the ``fpr.eviction.`` metrics namespace via
:meth:`WatermarkEvictor.counters`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

from repro_torch.core.events import EvictionPass
from repro_torch.core.fpr import FprMemoryManager

#: Linux kswapd LRU batch size (§II-A).
KSWAPD_BATCH = 32

# victim iterator yields (mapping_id, logical_idx, is_fpr) in LRU order
VictimIter = Callable[[], Iterable[tuple[int, int, bool]]]


@dataclass
class Watermarks:
    """Free-block thresholds as fractions of the pool."""

    min_frac: float = 0.02
    low_frac: float = 0.08
    high_frac: float = 0.15

    def resolve(self, num_blocks: int) -> tuple[int, int, int]:
        return (max(1, int(self.min_frac * num_blocks)),
                max(2, int(self.low_frac * num_blocks)),
                max(3, int(self.high_frac * num_blocks)))


@dataclass
class EvictionStats:
    wakeups: int = 0
    normal_batches: int = 0
    huge_batches: int = 0
    passes_normal: int = 0
    passes_huge: int = 0
    blocks_evicted: int = 0
    pages_scanned: int = 0         # victim candidates walked over all passes
    fpr_blocks_deferred: int = 0   # FPR blocks skipped in the low..min band


class WatermarkEvictor:
    """kswapd analogue driving :meth:`FprMemoryManager.evict`.

    Publishes one :class:`~repro_torch.core.events.EvictionPass` per completed
    pass on the manager's event bus and exposes :meth:`counters` for the
    ``fpr.eviction.`` metrics namespace.
    """

    def __init__(self, mgr: FprMemoryManager, victims: VictimIter,
                 watermarks: Watermarks | None = None):
        self.mgr = mgr
        self.bus = mgr.bus
        self.victims = victims
        wm = watermarks or Watermarks()
        self.wm_min, self.wm_low, self.wm_high = wm.resolve(mgr.num_blocks)
        self.stats = EvictionStats()

    def maybe_evict(self, *, worker: int = 0) -> int:
        """Run one daemon pass; returns blocks evicted."""
        free = self.mgr.free_blocks
        if free > self.wm_low:
            return 0
        self.stats.wakeups += 1
        if free > self.wm_min:
            return self._normal_pass(worker)
        return self._huge_pass(worker)

    def _resident(self, mid: int, idx: int) -> bool:
        """kswapd walks resident pages only; skip swapped/never-faulted."""
        m = self.mgr.tables.mappings.get(mid)
        return m is not None and m.physical[idx] >= 0

    def _publish_pass(self, kind: str, scanned: int, dropped: int,
                      deferred: int, free_before: int) -> None:
        if self.bus.wants(EvictionPass):
            self.bus.publish(EvictionPass(
                kind=kind, scanned=scanned, dropped=dropped,
                deferred=deferred, free_before=free_before,
                free_after=self.mgr.free_blocks))

    # -- low..min band: stock batches of 32, FPR pages exempt -----------------
    def _normal_pass(self, worker: int) -> int:
        free_before = self.mgr.free_blocks
        target = self.wm_high - free_before
        evicted = scanned = deferred = 0
        batch: list[tuple[int, int]] = []
        fpr_aware = self.mgr.fpr_enabled
        for mid, idx, is_fpr in self.victims():
            if evicted >= target:
                break
            scanned += 1
            if not self._resident(mid, idx):
                continue
            if fpr_aware and is_fpr:
                deferred += 1
                continue                      # §IV-B exemption
            batch.append((mid, idx))
            if len(batch) == KSWAPD_BATCH:
                evicted += self.mgr.evict(batch, fpr_batch=False, worker=worker)
                self.stats.normal_batches += 1
                batch = []
        if batch:
            evicted += self.mgr.evict(batch, fpr_batch=False, worker=worker)
            self.stats.normal_batches += 1
        self.stats.passes_normal += 1
        self.stats.pages_scanned += scanned
        self.stats.fpr_blocks_deferred += deferred
        self.stats.blocks_evicted += evicted
        self._publish_pass("normal", scanned, evicted, deferred, free_before)
        return evicted

    # -- at/below min: one huge batch, one merged fence ------------------------
    def _huge_pass(self, worker: int) -> int:
        free_before = self.mgr.free_blocks
        target = self.wm_high - free_before
        scanned = 0
        batch: list[tuple[int, int]] = []
        for mid, idx, _is_fpr in self.victims():
            if len(batch) >= target:
                break
            scanned += 1
            if not self._resident(mid, idx):
                continue
            batch.append((mid, idx))
        # an empty batch (every candidate non-resident) is still a pass:
        # account the scan and publish, or a starved daemon reads as
        # "never ran" (wakeups > passes) in the fpr.eviction.* counters
        evicted = (self.mgr.evict(batch, fpr_batch=True, worker=worker)
                   if batch else 0)
        self.stats.passes_huge += 1
        self.stats.pages_scanned += scanned
        if batch:
            self.stats.huge_batches += 1
        self.stats.blocks_evicted += evicted
        self._publish_pass("huge", scanned, evicted, 0, free_before)
        return evicted

    # ------------------------------------------------------------- counters
    def counters(self) -> dict:
        """The ``fpr.eviction.`` namespace source (every drop is a
        swap-out through the manager's swap path, so ``swap_outs`` ==
        ``pages_dropped`` by construction — both are reported so artifact
        consumers need no cross-namespace join)."""
        s = self.stats
        return {"wakeups": s.wakeups,
                "passes_normal": s.passes_normal,
                "passes_huge": s.passes_huge,
                "pages_scanned": s.pages_scanned,
                "pages_dropped": s.blocks_evicted,
                "swap_outs": s.blocks_evicted,
                "deferred": s.fpr_blocks_deferred}
