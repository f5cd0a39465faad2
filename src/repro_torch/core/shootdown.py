"""Coherence-fence engine — the TPU-serving analogue of a TLB shootdown.

Paper → framework mapping (DESIGN.md §2):

  TLB shootdown = IPI broadcast to every core that may cache the translation,
                  each core flushes, initiator *waits* for all confirmations.

  coherence fence = drain all in-flight async-dispatched engine steps (they
                  captured the old logical→physical block tables), bump the
                  table epoch, and re-broadcast the block tables to every
                  replica / shard that holds a copy.  The initiator waits.

Two cost surfaces are supported simultaneously:

  * measured  — an attached callback performs the *real* drain+rebroadcast on
                this host (``jax.block_until_ready`` + fresh ``device_put``);
                wall time is accumulated.
  * modeled   — a 1000-node projection: ``drain = dispatch_depth × step_time``
                plus ``broadcast = table_bytes / ici_bw × log2(replicas)``
                (tree broadcast), plus a per-IPI-analogue base latency.

The engine also owns the paper's §IV-C5 *global shootdown counter* (``epoch``):
every global fence increments it; block versions are stamped with it at free
time, letting later context-exit allocations elide their fence when any global
fence already intervened.

**Worker-scoped fences.**  The paper's core observation is that Linux
flushes *every* core because it does not know which cores actually cached a
translation; a global fence here reproduces that pessimism by refreshing all
``n_replicas`` table copies.  The scoped path (`fence_scoped`) is the
shootdown-filtering direction (numaPTE): :class:`~repro_torch.core.tracking.
BlockTracker` records a per-block worker-presence bitmask, so a fence needs
to cover only the workers that could hold a stale translation.  Bookkeeping:

  * ``seq``   — total fence ordinal; every fence (global or scoped) bumps it.
  * ``epoch`` — the §IV-C5 global counter: the ``seq`` of the last *global*
                fence.  Scoped fences do NOT bump it — eliding a context-exit
                fence because of an unrelated *scoped* fence would be unsound
                for workers outside its mask.
  * ``worker_epochs[w]`` — the ``seq`` of the last fence that covered worker
                ``w``.  A block freed at ``seq = v`` is clean for worker
                ``w`` iff ``worker_epochs[w] > v``; if every worker in the
                block's presence mask is clean the context-exit fence is
                elided entirely (``elided_by_scope``), otherwise it is scoped
                to the still-stale workers.

Versions are stamped with ``seq`` at free time; when scoped fencing is off
(or a single worker exists) ``seq == epoch`` and the behaviour is
bit-identical to the paper's global-epoch scheme.

**Sharded device-table refresh.**  Every fence is published as a
:class:`~repro_torch.core.events.FenceIssued` event carrying the covered worker
set (``workers is None`` for a global fence); the measured
drain+rebroadcast work happens in the subscribers (table-epoch bump, then
the device refresh).  Device-side (``PagedKVCache``), the block
table is split into one shard per worker — shard ``w`` holds the batch
slots with ``slot % num_workers == w``, and the engine binds each slot to
its serving worker at admission — and a fence re-uploads the covered
workers' shards plus the shards of every slot bound to a covered worker;
a global fence falls back to re-uploading every shard.  (Host-side,
``BlockTableStore`` applies the same rule to slot-overflow rows: a scoped
``bump_epoch`` also invalidates foreign shards holding a covered worker's
rows — on *every* covering fence while the overflowed mapping is live,
since new shard copies taken between fences can go stale again, and once
more after the mapping is destroyed to flush the dead row's residue.)

*What a shard refresh covers:* every table row a covered worker's in-flight
dispatches could have captured, because rows are read per slot and every
slot's serving worker is tracked.  Workers outside the mask keep their
device copies, which is sound for the same reason the scoped fence itself
is: their presence bit is not set for any block freed since their last
covering fence, so no translation they hold moved — their shard epoch
(``BlockTableStore.shard_epochs[w]``) stays put and their copies validate.

*When the global fallback triggers:* scoping disabled, a mask covering
every worker, an ALWAYS_FLUSH (§IV-C4 merge-conflict) block, or a
MAP_FIXED allocation — exactly the cases where per-worker staleness
tracking is unavailable or vacuous.  Soundness therefore never depends on
a shard refresh being "enough": whenever coverage is uncertain, the path
degenerates to the paper's full-broadcast fence.

**Elastic resharding.**  The worker topology may change at runtime
(``FprMemoryManager.reshard`` / ``Engine.resize_workers``) without
dropping a single live mapping.  The soundness invariant — *no worker
reads a block version newer than its last covering fence* — survives the
reshard because every piece of per-worker bookkeeping is carried across
through one old→new **worker translation table** ``t`` (growth: the
identity; shrink to ``W'``: ``t(w) = w mod W'``), each in the direction
that can only *add* fences, never lose one:

  * ``worker_epochs[w']`` becomes the **min** over the old workers
    translating to ``w'`` (:meth:`FenceEngine.reshard_workers`).  The
    epoch means "``w'`` was covered by the fence at this ``seq``"; a
    merged worker is only as clean as its *stalest* constituent, so min
    is the sound merge — claiming the max would elide a context-exit
    fence for a constituent that was never covered.  Brand-new workers
    (ids outside ``t``'s image) start at the current ``seq``: they cannot
    hold translations to anything freed before they existed.
  * Presence masks are rewritten bit-by-bit through ``t``
    (:meth:`~repro_torch.core.tracking.BlockTracker.remap_workers`): a block
    freed under the old topology keeps naming, in new-topology ids, every
    worker that could still cache its translation.  The aliased top bit
    (workers ≥ 63) expands conservatively to all new workers.
  * ``BlockTableStore.shard_epochs[s']`` becomes the **max** over the old
    shards whose slots land in ``s'`` — the opposite direction of the
    worker epochs, because a shard epoch *invalidates* copies
    (``copy_epoch < shard_epochs[s]`` ⇒ stale): max keeps every
    previously-stale copy stale (possibly spuriously invalidating a valid
    one — a wasted refresh, never a wrong read).

  On top of the carried state, the slots whose device-shard *owner*
  changes (``t(slot mod W) != slot mod W'``) are the **moved rows**: their
  data must reach a worker that never held it, and their old holders'
  in-flight dispatches are drained and their epochs bumped by one scoped
  ``reason="reshard"`` fence over exactly the pre-existing workers that
  lost live rows.  Rows that stay put keep their device copies — a
  topology change costs the moved fraction of the table, not a cold
  start, which is the paper's argument applied to the topology event
  itself: invalidate what moved, not the whole machine.

**Two-level island topology.**  With workers grouped into *islands*
(:mod:`repro_torch.core.topology` — hosts / NUMA domains, the numaPTE analogue
of per-node page-table replicas), the scoped fence gains a second level
above the per-worker one, and the soundness argument extends along three
directions:

  * **Island summary epochs are derived mins.**  ``island_epochs[i]`` is
    *defined* as ``min(worker_epochs[w] for w in island i)`` and
    re-derived after every fence and every reshape — so a merged island
    is exactly as stale as its stalest constituent by construction, and
    an island-level "covered since ``v``" claim
    (``island_epochs[i] > v``) implies the same claim for every member
    worker.  The island level can therefore only *elide less* than the
    worker level, never more: any check it passes, the per-worker check
    (which remains the authoritative one in ``stale_masks``) passes too.
  * **Island summary presence bits are conservative ORs.**
    :class:`~repro_torch.core.tracking.BlockTracker` keeps, above the
    per-worker presence mask, one summary bit per island — set whenever
    any member worker's bit is set, recomputed from the worker mask on
    every remap/reset, with the aliased top bit (workers ≥ 63) expanding
    to *all* islands.  A clear summary bit is thus a proof that no
    worker in that island holds the translation; a set bit claims
    nothing beyond "some member might".  Exactly the per-worker mask
    argument, one level up.
  * **Cross-island fences are remote shootdowns.**  A scoped fence whose
    covered worker set spans islands pays the ``cross_island_cost``
    multiplier (the IPI crosses the interconnect) and propagates the
    table change to each covered remote island's replica group as a
    *delta* (``deltas_propagated`` / ``device.island.delta_bytes``) —
    the update still reaches every replica that could hold the stale
    translation, it is only *accounted* (and, on real hardware, shipped)
    as an incremental remote invalidation instead of a local full
    re-upload.  Intra-island fences touch no remote replica at all,
    which is sound because the covered workers' presence bits all live
    under one island summary bit: no other island's replica group can
    hold a stale copy of the covered translations.  The flat
    single-island topology degenerates to the pre-island engine
    bit-for-bit — every fence is intra-island and no multiplier, delta,
    or extra counter exists.

**Averted fences and the admission phase.**  The paper's §IV-A check runs
at allocation: a freed block's deferred invalidation is resolved when the
block is next handed out — recycled in-context (no fence, ever), elided
by the §IV-C5 epoch or a covering per-worker fence, or fenced because it
left its context.  The serving stack adds one phase upstream of that:
**admission** (``repro_torch.serving.admission``) decides *which* request the
freed blocks reach, so admission policy controls how often the
allocation-phase check lands in the fence-free branches — the
recycle-affinity policy admits the freed stream's next request and turns
nearly every resolution into a ``recycled_hit``.  An allocation batch
whose deferred invalidations all resolve without a fence counts one
``fences_averted`` event and credits ``replicas_spared`` with the *full*
modeled broadcast (the baseline would have shot down every replica at the
munmap); a scoped fence credits only the uncovered share.
``replicas_spared`` therefore measures total broadcast traffic avoided
relative to the always-global baseline, across both mechanisms.
Preemption (the kswapd analogue) reuses the same machinery: a recompute
victim's blocks recycle through a skipped-at-free munmap, and a swap
victim's eviction batch takes the §IV-B merged fence.

**Sharing sets (prefix sharing / COW).**  The soundness argument extends
unchanged to blocks with *several* simultaneous owners
(:mod:`repro_torch.core.prefix`).  A refcounted shared block is **pinned**: it
never reaches the allocator while any sharer maps it, so no freed-stale
translation of it can exist and attaching another sharer needs no fence —
structurally, not by elision.  The paper's "page leaves its recycling
cycle" moment is the **sharing exit**: the last sharer detaches, the
block leaves its set and rejoins ordinary recycling carrying (a) its
version stamped at that free and (b) a presence mask that is the *union*
of every former sharer's worker bits (each attach ORed its worker in, and
FPR frees keep the mask).  The next allocation therefore resolves the
deferred invalidation exactly as above — recycled in-context, elided by
epoch/worker-epoch, or fenced scoped to the union mask — and the
first foreign reuse after a sharing exit is covered by the same
context-exit check that covers any other free (``fpr.prefix.
exit_fenced`` / ``exit_elided`` split the outcome).  COW divergence
allocates a *fresh* block for the writer and detaches it from the set;
the shared block's refcount drops but its history is untouched, so
neither side needs a fence.  The invariant "a refcounted block is never
seen by the allocator or the fence path" is asserted at alloc/free and
counted in ``fpr.prefix.in_set_violations`` (must stay 0).

**Chunked prefill.**  Admitting a request on its first prefill chunk and
growing the reservation per chunk (``Engine._prefill_chunk_step`` /
``_grow_for_decode``) adds **no new fence source**: every chunk's blocks
are acquired through ``FprMemoryManager.extend`` — the same §IV-A
allocation-phase check as any mmap, so each recycled block's deferred
invalidation is resolved right there (recycled in-context, elided by
epoch/worker-epoch, or fenced scoped to its presence mask) before the
chunk ever writes into it.  Chunking therefore only changes *when*
blocks commit to a mapping — one chunk at a time instead of the whole
window up front — never the fence rules those commits go through; a
mid-prefill sequence is just a mapping that happens to still be growing.
The interleaved step (prefill chunks and decode steps sharing one engine
iteration) preserves the invariant for the same reason: the chunk and
the decode batch read only rows of *their own* slots' table shards, and
any fence triggered by one's allocation refreshes the covered shards
before the next dispatch captures them, exactly as with whole-window
prefill.  Eviction interacts through ``Engine._lru_victims``, which
never offers the block a sequence's next write lands in (and offers
nothing at all from a still-growing prefill mapping, whose entire
written history the next chunk reads).

**Ragged fused-KV kernel.**  The serving kernel
(:mod:`repro_torch.kernels.paged_attention`) is the *reader* side of the paper's
"one translation, more reach" argument.  A translation the fence protocol
guarantees valid is a block-table row; what that row buys per lookup is
the kernel's business.  Fusing K and V head-interleaved into one pool
block means each validated row now covers **one** contiguous DMA carrying
the block's entire KV payload instead of two half-sized descriptors
walking two pools — twice the reach per translation, half the page walks
per attended block, exactly the paper's economics of making each
(expensively kept coherent) translation serve more bytes.  The ragged
batch descriptor extends the same trade across *rows*: mixed
prefill-chunk and decode sequences share one kernel launch, so one
captured table snapshot per layer per step serves every slot's walk.
None of this touches soundness: the kernel only changes how *resident*
blocks are read — which descriptors, how many, how deeply the copies are
pipelined — never when a block is freed, recycled, or fenced.  Every
table row it dereferences was uploaded by the shard-refresh path above,
its in-flight dispatches are drained by the same fence drain, and the
multi-depth DMA pipeline lives entirely within one dispatch, so a fence
never interleaves with a half-prefetched block.  The fence/version
protocol is byte-for-byte the one documented above, with or without the
fused kernel.
"""

from __future__ import annotations

import math
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.events import EventBus, FenceIssued
from repro_torch.core.tracking import WORKER_OVERFLOW_BIT, worker_bit


@dataclass(frozen=True)
class FenceCostModel:
    """Projected fence cost for a large deployment (defaults: TPU v5e pod)."""

    n_replicas: int = 256          # table-holding shards that must be refreshed
    dispatch_depth: int = 4        # async steps in flight that must drain
    step_time_s: float = 15e-3     # decode step wall time
    table_bytes: int = 4 << 20     # block tables + handles to rebroadcast
    link_bw: float = 50e9          # ~50 GB/s/link ICI (assignment constant)
    base_latency_s: float = 25e-6  # interrupt/RPC base cost per fence
    cross_island_cost: float = 4.0  # multiplier a fence pays when its worker
                                    # set spans islands (inter-host hop)

    def cost_s(self, replicas: int | None = None) -> float:
        """Modeled cost of refreshing ``replicas`` table copies.

        The drain term is accounted as aggregate replica-work (the decode
        throughput the fence steals across the affected shards), so a fence
        scoped to ``k`` of ``n_replicas`` replicas costs ``k/n`` of the
        global drain plus a ``log2(k)`` tree broadcast.
        """
        k = self.n_replicas if replicas is None else max(1, replicas)
        drain = (self.dispatch_depth * self.step_time_s
                 * (k / max(1, self.n_replicas)))
        hops = max(1.0, math.log2(max(2, k)))
        broadcast = (self.table_bytes / self.link_bw) * hops
        return self.base_latency_s + drain + broadcast


@dataclass
class FenceStats:
    fences: int = 0                      # fences actually performed
    fences_by_reason: Counter = field(default_factory=Counter)
    blocks_covered: int = 0              # blocks whose invalidation each fence covered
    skipped_at_free: int = 0             # §IV-A: shootdown skipped on FPR free
    elided_by_version: int = 0           # §IV-C5: context-exit fence elided
    elided_by_scope: int = 0             # per-worker-epoch elision (scoped)
    elided_always_flush: int = 0         # ALWAYS_FLUSH fences (subset of fences)
    fences_scoped: int = 0               # fences that covered < all workers
    fences_averted: int = 0              # deferred invalidations resolved
                                         # with no fence at all (recycled or
                                         # elided allocation batches)
    workers_covered: int = 0             # Σ workers covered over all fences
    replicas_spared: int = 0             # Σ modeled replicas NOT refreshed
                                         # vs the always-global baseline: a
                                         # scoped fence spares the uncovered
                                         # share, an averted fence the full
                                         # broadcast
    measured_s: float = 0.0              # accumulated real fence wall time
    modeled_s: float = 0.0               # accumulated projected fence cost

    def snapshot(self) -> dict:
        d = {k: (dict(v) if isinstance(v, Counter) else v)
             for k, v in self.__dict__.items()}
        return d


@dataclass
class IslandFenceStats:
    """Two-level accounting, materialised only for multi-island topologies
    (the flat degenerate case keeps :class:`FenceStats` — and every
    artifact — byte-identical to the single-level engine)."""

    fences_intra: int = 0           # scoped fences inside one island
    fences_cross: int = 0           # scoped fences spanning islands
    deltas_propagated: int = 0      # Σ remote island replicas updated by
                                    # delta (one per covered island beyond
                                    # the first on every cross fence)
    modeled_intra_s: float = 0.0    # Σ modeled cost of intra fences
    modeled_cross_s: float = 0.0    # Σ modeled cost of cross fences
                                    # (includes the cross_island_cost
                                    # multiplier)

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class FenceEngine:
    """Owns the fence epochs and performs/records coherence fences.

    Every fence is published as a :class:`~repro_torch.core.events.FenceIssued`
    event on :attr:`bus`; the table-epoch bump, the device shard refresh
    and any external observers are subscribers.  ``measured_s`` accumulates
    the wall time of the whole dispatch (the drain+rebroadcast cost the
    paper's shootdown pays) whenever ``measure`` is on.
    """

    def __init__(self, cost_model: FenceCostModel | None = None, *,
                 measure: bool = True, num_workers: int = 1,
                 scoped: bool = True, bus: EventBus | None = None,
                 topology=None):
        self.seq = 1                      # total fence ordinal (all fences)
        self.epoch = 1                    # global shootdown counter (§IV-C5)
        self.cost_model = cost_model or FenceCostModel()
        self.bus = bus if bus is not None else EventBus()
        self.measure = measure
        self.scoped = scoped              # False ⇒ every fence is global
        self.worker_epochs = np.full(max(1, num_workers), 1, dtype=np.int64)
        self.stats = FenceStats()
        # two-level topology (None = flat): island summary epochs are the
        # derived min over each island's worker epochs, so the merged-
        # island invariant (as stale as the stalest constituent) holds by
        # construction; island accounting only materialises multi-island
        self.topology = None
        self.island_epochs = np.full(1, 1, dtype=np.int64)
        self.island_stats: IslandFenceStats | None = None
        if topology is not None:
            self.set_topology(topology)

    # The one-release ``on_fence`` deprecation window has closed.  A
    # raising tombstone (instead of plain attribute absence) keeps the
    # failure loud: silently setting an attribute nothing reads would
    # drop the caller's measured-refresh hook without a trace.
    @property
    def on_fence(self):
        raise TypeError("FenceEngine.on_fence was removed; subscribe to "
                        "FenceIssued on FenceEngine.bus instead "
                        "(bus.subscribe(FenceIssued, handler))")

    @on_fence.setter
    def on_fence(self, fn) -> None:
        raise TypeError("FenceEngine.on_fence was removed; subscribe to "
                        "FenceIssued on FenceEngine.bus instead "
                        "(bus.subscribe(FenceIssued, handler))")

    # ------------------------------------------------------------- workers
    @property
    def num_workers(self) -> int:
        return len(self.worker_epochs)

    # -------------------------------------------------------------- islands
    @property
    def num_islands(self) -> int:
        return 1 if self.topology is None else self.topology.num_islands

    def set_topology(self, topology) -> None:
        """Install (or change) the worker → island partition.

        Island epochs are re-derived as the min over each island's worker
        epochs — a merged island is exactly as stale as its stalest
        constituent, so no island-level summary ever claims a fence a
        member worker did not receive.  A flat (single-island / ``None``)
        topology drops the island accounting entirely: the engine is
        bit-identical to the pre-island single-level one.
        """
        if topology is not None and topology.num_workers > self.num_workers:
            # A topology may not name workers the engine has never seen;
            # the converse (engine grown past the topology by a sharing
            # observer) is fine — surplus workers fold through the modulo
            # rule, exactly like the epoch-table default.
            self.ensure_workers(topology.num_workers)
        self.topology = topology
        if topology is None or topology.is_flat:
            self.island_stats = None
        elif self.island_stats is None:
            self.island_stats = IslandFenceStats()
        self._derive_island_epochs()

    def _derive_island_epochs(self) -> None:
        """``island_epochs[i] = min(worker_epochs[w] for w in island i)``
        (workers grown past the topology fold through the modulo rule)."""
        t = self.topology
        if t is None:
            self.island_epochs = np.full(1, int(self.worker_epochs.min()),
                                         dtype=np.int64)
            return
        mins = np.full(t.num_islands, self.seq, dtype=np.int64)
        for w in range(len(self.worker_epochs)):
            i = t.island_of(w)
            mins[i] = min(int(mins[i]), int(self.worker_epochs[w]))
        self.island_epochs = mins

    def islands_of(self, workers) -> tuple:
        """Island ids covered by a worker set (flat topology: ``(0,)``)."""
        if self.topology is None:
            return (0,)
        return self.topology.islands_of(workers)

    def island_epoch_counters(self) -> dict:
        """Per-island summary-epoch snapshot for counters/benchmarks."""
        return {f"i{i}": int(e) for i, e in enumerate(self.island_epochs)}

    def ensure_workers(self, n: int) -> None:
        """Grow the per-worker epoch table to at least ``n`` workers.

        New workers start at the current ``seq``: they cannot hold stale
        translations to anything freed before they existed.
        """
        if n > len(self.worker_epochs):
            extra = np.full(n - len(self.worker_epochs), self.seq,
                            dtype=np.int64)
            self.worker_epochs = np.concatenate([self.worker_epochs, extra])
            self._derive_island_epochs()

    def reshard_workers(self, new_num_workers: int, translation) -> None:
        """Carry per-worker fence epochs across an elastic reshard.

        ``translation[w]`` is the new id inheriting old worker ``w``'s
        bookkeeping.  A merged new worker takes the **min** of its
        constituents' epochs — it is only as clean as its stalest source
        (see the module docstring's reshard soundness argument).  New
        workers outside the translation's image start at the current
        ``seq``: nothing freed before they existed can be stale for them.

        ``worker_epochs`` may be longer than the translation table —
        :meth:`ensure_workers` grows it for observers (e.g. the sim's
        compute workers) beyond the manager's topology.  Those extra
        workers fold through the default rule (identity, else modulo),
        so a shared fence engine never indexes the table out of range.
        The new epoch array is built in full before assignment: a
        malformed entry raises with the engine untouched.
        """
        if new_num_workers < 1:
            raise ValueError(f"need >= 1 worker, got {new_num_workers}")
        old = self.worker_epochs
        try:
            n_trans = len(translation)
        except TypeError:
            n_trans = len(old)
        # fresh workers (no old constituent) start at the current seq; a
        # constituent's epoch can only lower that (epochs never exceed seq)
        new = np.full(new_num_workers, self.seq, dtype=np.int64)
        for w in range(len(old)):
            if w < n_trans:
                t = int(translation[w])
            else:                         # beyond the topology: default rule
                t = w if w < new_num_workers else w % new_num_workers
            if not (0 <= t < new_num_workers):
                raise ValueError(
                    f"translation maps worker {w} to {t}, outside the new "
                    f"topology of {new_num_workers} workers")
            new[t] = min(int(new[t]), int(old[w]))
        self.worker_epochs = new
        # a reshard that changes the worker count invalidates the old
        # island partition; fall back to flat until the caller installs
        # the new one (FprMemoryManager.reshard passes it through)
        if (self.topology is not None
                and self.topology.num_workers != new_num_workers):
            self.set_topology(None)
        else:
            self._derive_island_epochs()

    def _workers_in(self, mask: int) -> np.ndarray:
        """Worker ids selected by a presence mask (bit 63 ⇒ all high ids)."""
        mask = int(mask)
        ids = [w for w in range(min(self.num_workers, WORKER_OVERFLOW_BIT))
               if mask >> w & 1]
        if mask >> WORKER_OVERFLOW_BIT & 1:
            ids.extend(range(WORKER_OVERFLOW_BIT, self.num_workers))
        return np.asarray(ids, dtype=np.int64)

    def stale_masks(self, masks: np.ndarray,
                    versions: np.ndarray) -> np.ndarray:
        """Per-block mask of workers still holding a stale translation.

        Worker ``w`` is stale for a block freed at ``seq = v`` iff the
        block's presence mask names it and no fence covered it since
        (``worker_epochs[w] <= v``).
        """
        stale = np.zeros(len(masks), dtype=np.uint64)
        if len(masks) == 0:
            return stale
        union = int(np.bitwise_or.reduce(masks))
        if union == 0:
            return stale
        # iterate only the workers actually present in some mask — bounded
        # by the number of distinct holders (typically 1), not num_workers
        for w in self._workers_in(union):
            bit = worker_bit(w)
            s = ((masks & bit) != 0) & (versions
                                        >= np.uint64(self.worker_epochs[w]))
            stale |= np.where(s, bit, np.uint64(0))
        return stale

    # ------------------------------------------------------------------ fences
    def fence(self, reason: str, n_blocks: int = 1) -> int:
        """Perform one global coherence fence. Returns the new epoch."""
        self.seq += 1
        self.epoch = self.seq
        self.worker_epochs[:] = self.seq
        self.island_epochs[:] = self.seq   # every island fully covered
        st = self.stats
        st.fences += 1
        st.fences_by_reason[reason] += 1
        st.blocks_covered += n_blocks
        st.workers_covered += self.num_workers
        st.modeled_s += self.cost_model.cost_s()
        self._publish(reason, n_blocks, None, scoped=False)
        return self.epoch

    def fence_scoped(self, reason: str, n_blocks: int = 1,
                     worker_mask: int = 0) -> int:
        """Fence only the workers named by ``worker_mask``.

        Cost (modeled and measured) is proportional to the mask popcount;
        only the covered workers' epochs advance — the global epoch does
        not, so §IV-C5 elision stays sound for uncovered workers.  Falls
        back to a global fence when scoping is off or the mask covers
        every worker.
        """
        workers = self._workers_in(worker_mask)
        if (not self.scoped or len(workers) == 0
                or len(workers) >= self.num_workers):
            return self.fence(reason, n_blocks)
        self.seq += 1
        self.worker_epochs[workers] = self.seq
        st, cm = self.stats, self.cost_model
        st.fences += 1
        st.fences_scoped += 1
        st.fences_by_reason[reason] += 1
        st.blocks_covered += n_blocks
        st.workers_covered += len(workers)
        affected = max(1, math.ceil(cm.n_replicas * len(workers)
                                    / self.num_workers))
        st.replicas_spared += cm.n_replicas - affected
        cost = cm.cost_s(affected)
        # two-level scoping: the narrowest level is picked from the
        # covered worker set itself — one island ⇒ the ordinary scoped
        # cost (bit-identical to the flat engine), several ⇒ the fence
        # crosses the interconnect and pays the cross_island_cost
        # multiplier while the remote covered islands' replicas take
        # delta-propagated updates (counted, remote shootdowns)
        isl = self.island_stats
        if isl is not None:
            covered = self.islands_of(workers)
            if len(covered) <= 1:
                isl.fences_intra += 1
                isl.modeled_intra_s += cost
            else:
                cost *= cm.cross_island_cost
                isl.fences_cross += 1
                isl.deltas_propagated += len(covered) - 1
                isl.modeled_cross_s += cost
            # refresh the island summary epochs (derived min, so the
            # two-level consistency invariant holds after every fence)
            self._derive_island_epochs()
        st.modeled_s += cost
        self._publish(reason, n_blocks, workers, scoped=True)
        return self.epoch

    def _publish(self, reason: str, n_blocks: int,
                 workers: np.ndarray | None, *, scoped: bool) -> None:
        """Publish the fence as a :class:`FenceIssued` event.

        ``workers`` is ``None`` for a global fence (refresh every table
        shard) or the covered worker ids for a scoped one — subscribers
        (table-epoch bump, ``PagedKVCache`` shard refresh) scope their
        invalidation to them.  With ``measure`` on, the dispatch wall time
        is the fence's measured drain+rebroadcast cost.
        """
        if not self.bus.wants(FenceIssued):
            return
        evt = FenceIssued(
            reason=reason, n_blocks=n_blocks,
            workers=None if workers is None else tuple(int(w)
                                                       for w in workers),
            seq=self.seq, epoch=self.epoch, scoped=scoped)
        if self.measure:
            t0 = time.perf_counter()
            self.bus.publish(evt)
            self.stats.measured_s += time.perf_counter() - t0
        else:
            self.bus.publish(evt)

    # -------------------------------------------------------------- accounting
    def note_skipped_free(self, n_blocks: int = 1) -> None:
        self.stats.skipped_at_free += n_blocks

    def note_version_elision(self, n_blocks: int = 1) -> None:
        self.stats.elided_by_version += n_blocks

    def note_scope_elision(self, n_blocks: int = 1) -> None:
        self.stats.elided_by_scope += n_blocks

    def note_fence_averted(self) -> None:
        """An allocation batch resolved its deferred invalidations with no
        fence at all — every block was recycled in-context or elided by
        version/scope.  The baseline would have sent one merged broadcast
        to all ``n_replicas`` for the batch, so crediting is per *event*
        (mirroring the per-event ``replicas_spared`` of a scoped fence),
        never per block.  (Admission order controls how often this
        happens: recycle-affinity admission maximises it.)
        """
        st = self.stats
        st.fences_averted += 1
        st.replicas_spared += self.cost_model.n_replicas

    def reset_stats(self) -> None:
        self.stats = FenceStats()

    # Convenience for benchmarks: totals with/without FPR-visible savings.
    def totals(self) -> dict:
        s = self.stats
        out = {
            "fences": s.fences,
            "fences_scoped": s.fences_scoped,
            "fences_averted": s.fences_averted,
            "skipped_at_free": s.skipped_at_free,
            "elided_by_version": s.elided_by_version,
            "elided_by_scope": s.elided_by_scope,
            "workers_covered": s.workers_covered,
            "replicas_spared": s.replicas_spared,
            "measured_s": round(s.measured_s, 6),
            "modeled_s": round(s.modeled_s, 6),
            "by_reason": dict(s.fences_by_reason),
        }
        # island accounting only exists multi-island — flat runs (and
        # every pre-island artifact) keep a byte-identical key set
        if self.island_stats is not None:
            isl = self.island_stats
            out["island"] = {
                "num_islands": self.num_islands,
                "fences_intra": isl.fences_intra,
                "fences_cross": isl.fences_cross,
                "deltas_propagated": isl.deltas_propagated,
                "modeled_intra_s": round(isl.modeled_intra_s, 6),
                "modeled_cross_s": round(isl.modeled_cross_s, 6),
            }
        return out

    def worker_epoch_counters(self) -> dict:
        """Per-worker epoch snapshot for counters()/benchmark reports."""
        return {f"w{w}": int(e) for w, e in enumerate(self.worker_epochs)}
