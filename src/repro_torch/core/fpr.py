"""FprMemoryManager — the paper's contribution as a composable module.

Ties together the four mechanisms of §IV:

  * tracking checks at **allocation** (fence moved from release → allocation),
  * fence **skipping** at free for in-context blocks,
  * **version/global-epoch elision** of context-exit fences (§IV-C5),
  * monotonic logical IDs (ABA, §IV-B) + MAP_FIXED forced-fence rule,
  * the baseline mode (``fpr_enabled=False``) reproduces stock Linux:
    one batched fence per munmap / per eviction batch.

On top of the paper, fences are **worker-scoped** (``scoped_fences=True``):
every allocation/touch stamps the worker's bit into the block's presence
mask, so when a fence *is* required (context exit, baseline munmap,
eviction) it covers only the workers that could hold a stale translation —
see :mod:`repro_torch.core.shootdown` for the epoch bookkeeping and
:mod:`repro_torch.core.tracking` for the mask.  The allocation hot path is
batched: one :meth:`BlockAllocator.acquire` call and one vectorised
tracking check per request instead of a per-block Python loop.

**Prefix sharing** (``config.prefix_sharing``, FPR only): mappings created
with ``prefix_hashes`` attach to already-indexed common-prefix blocks
instead of allocating them.  While a block stays inside its *sharing set*
(refcount > 0) it is pinned — never freed, never fenced; when the last
sharer detaches the block exits the set and rejoins the recycling
machinery, where the existing allocation-phase checks fence (or elide)
its first foreign reuse.  See :mod:`repro_torch.core.prefix`.

The manager is engine-agnostic: the serving engine (repro/serving) and the
microbenchmarks both drive it through the same mmap/munmap/touch/evict API.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.allocator import BlockAllocator, BlockLease
from repro_torch.core.block_table import BlockTableStore, Mapping
from repro_torch.core.config import (FprConfig, validate_translation,
                               validate_worker_count)
from repro_torch.core.contexts import RecyclingContext
from repro_torch.core.events import (BlocksRecycled, BlocksShared, ContextExit,
                               FenceIssued, SharingExit, SwapDropped,
                               TopologyChanged)
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.prefix import PrefixIndex, PrefixStats
from repro_torch.core.shootdown import FenceEngine
from repro_torch.core.tracking import (FLAG_ALWAYS_FLUSH, FLAG_WAS_SHARED,
                                 BlockTracker, worker_bit)

SWAPPED = -2          # block-table marker: resident → swapped out
NOT_RESIDENT = -1     # never faulted in


@dataclass
class FprStats:
    allocs: int = 0
    frees: int = 0
    recycled_hits: int = 0        # allocation found its own context's block
    clean_allocs: int = 0         # tracking id was 0
    context_exits: int = 0        # blocks that left a recycling context
    faults: int = 0               # touch() on non-resident block
    swap_ins: int = 0
    swap_outs: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class FprMemoryManager:
    """Paged-memory manager with fast page recycling.

    Construction: ``FprMemoryManager(config=FprConfig(...))`` (optionally
    with a shared ``fence_engine``).

    Cross-layer observations are published on :attr:`bus` (the fence
    engine's :class:`~repro_torch.core.events.EventBus`): ``FenceIssued``,
    ``BlocksRecycled``, ``ContextExit``, ``BlocksShared``, ``SharingExit``,
    ``SwapDropped``, ``TopologyChanged``.  Counters are registered on
    :attr:`metrics` under the ``fpr``/``fpr.prefix``/``fence``/``table``
    namespaces.
    """

    def __init__(self, *, config: FprConfig | None = None,
                 fence_engine: FenceEngine | None = None):
        if config is None:
            raise TypeError(
                "FprMemoryManager requires config=FprConfig(...)")
        self.config = config
        num_workers = config.num_workers
        self.tracker = BlockTracker(config.num_blocks)
        self.alloc = BlockAllocator(config.num_blocks, self.tracker,
                                    num_workers=num_workers,
                                    pcp_batch=config.pcp_batch,
                                    pcp_high=config.pcp_high,
                                    max_order=config.max_order)
        self.tables = BlockTableStore(config.max_seqs,
                                      config.max_blocks_per_seq,
                                      num_shards=num_workers)
        self.fences = fence_engine or FenceEngine()
        self.bus = self.fences.bus
        self.fences.ensure_workers(num_workers)
        if config.islands is not None:
            self.set_topology(config.topology())
        if config.scoped_fences is not None:  # None ⇒ respect engine's flag
            self.fences.scoped = config.scoped_fences
        # Every fence invalidates device-held tables: couple the epochs.  A
        # scoped fence names its covered workers → only those table shards
        # are invalidated/refreshed; a global fence (workers=None) hits all.
        # Prepended so the host-side epoch bump precedes every other
        # subscriber, even one attached at fence-engine construction
        # before this manager existed — ``first=True`` keeps the
        # coherence order explicit.
        self.bus.subscribe(FenceIssued, self._on_fence_issued, first=True)
        self.fences.measure = True
        self.fpr_enabled = config.fpr_enabled
        self.stats = FprStats()
        self.reshards = 0
        # Prefix sharing: sharing sets over token-block hashes.  Only
        # meaningful under FPR (a sharing exit re-enters the recycling
        # machinery); gated independently so the differential benchmarks
        # can isolate its effect.
        self.prefix = PrefixIndex()
        self.prefix_stats = PrefixStats()
        self.prefix_sharing = config.fpr_enabled and config.prefix_sharing
        # Airtight exit discipline: the allocator refuses any block whose
        # sharing refcount is still live (see BlockLease.manager).
        self.alloc.refcount_of = self.tracker.refcounts
        self.metrics = MetricsRegistry()
        self.metrics.register("fpr", lambda: self.stats.snapshot())
        self.metrics.register("fence", self._fence_metrics)
        self.metrics.register("table", self._table_metrics)
        self.metrics.register(
            "fpr.prefix", lambda: self.prefix_stats.counters(self.prefix))
        #: optional swap hooks (serving attaches pool copy-out/copy-in —
        #: the "storage device" behind eviction).  Signatures:
        #:   on_swap_out(mapping_id, logical_idx, phys_block)
        #:   on_swap_in(mapping_id, logical_idx, new_phys_block)
        #: A mapping destroyed while blocks are swapped out publishes
        #: :class:`~repro_torch.core.events.SwapDropped` per block instead —
        #: subscribe to it to release swap-store copies.
        self.on_swap_out = None
        self.on_swap_in = None

    def _on_fence_issued(self, evt: FenceIssued) -> None:
        self.tables.bump_epoch(shards=evt.workers)

    # The one-release ``on_swap_drop`` deprecation window has closed.
    # A raising tombstone (instead of plain attribute absence) keeps the
    # failure loud: silently setting an attribute the manager never reads
    # would orphan swap-store copies forever.
    @property
    def on_swap_drop(self):
        raise TypeError("FprMemoryManager.on_swap_drop was removed; "
                        "subscribe to SwapDropped on "
                        "FprMemoryManager.bus instead")

    @on_swap_drop.setter
    def on_swap_drop(self, fn) -> None:
        raise TypeError("FprMemoryManager.on_swap_drop was removed; "
                        "subscribe to SwapDropped on "
                        "FprMemoryManager.bus instead")

    # ================================================================== metrics
    def _fence_metrics(self) -> dict:
        d = self.fences.totals()
        d["worker_epochs"] = self.fences.worker_epoch_counters()
        if self.fences.island_stats is not None:
            d["island_epochs"] = self.fences.island_epoch_counters()
        return d

    def _table_metrics(self) -> dict:
        d = {"epoch": self.tables.epoch,
             "num_shards": self.tables.num_shards,
             "reshards": self.reshards,
             "shard_epochs": [int(e) for e in self.tables.shard_epochs],
             "shard_overflows": self.tables.shard_overflows,
             "stale_lookups_detected": self.tables.stale_lookups_detected}
        isl = self.tables.island_totals()
        if isl is not None:
            d["island"] = isl
        return d

    # ================================================================= topology
    @property
    def topology(self):
        """The installed multi-island topology, ``None`` when flat."""
        return self.fences.topology

    def set_topology(self, topology) -> None:
        """Install a worker → island partition on every coherence layer
        (tracker summary bits, two-level fence engine, table replica
        groups).  ``None`` or a flat spec drops back to the single-level
        engine.  The partition must cover exactly the current worker
        count — reshaping worker counts goes through :meth:`reshard`.
        """
        from repro_torch.core.topology import Topology
        topo = (None if topology is None
                else Topology.of(topology,
                                 num_workers=self.config.num_workers))
        if topo is not None and topo.is_flat:
            topo = None
        self.tracker.set_topology(topo)
        self.fences.set_topology(topo)
        self.tables.set_topology(topo)
        self.config = self.config.replace(
            islands=None if topo is None else topo.spec)

    # ================================================================== reshard
    @property
    def num_workers(self) -> int:
        return self.config.num_workers

    def default_translation(self, new_num_workers: int) -> tuple:
        """The canonical old→new worker map: identity on growth (old
        workers keep their ids), modulo folding on shrink (worker ``w``
        merges into ``w % new``)."""
        return tuple(w if w < new_num_workers else w % new_num_workers
                     for w in range(self.config.num_workers))

    def reshard(self, new_num_workers: int, translation=None,
                extra_fence_workers=(), topology=None) -> dict:
        """Elastic topology change: remap every per-worker structure onto
        ``new_num_workers`` without invalidating live mappings.

        Order matters and mirrors the soundness argument in
        ``shootdown.py``:

          1. presence masks and per-worker fence epochs are carried
             through ``translation`` (min-merge for epochs, bit-OR for
             masks) and the fence engine's worker table is resized;
          2. the block-table store repartitions slots/epochs/free-lists/
             overflow records (max-merge for shard epochs) and reports
             the *moved* rows — slots whose translated shard owner
             changed;
          3. a :class:`TopologyChanged` event is published (subscribers —
             the device cache — repartition their shard arrays from it);
          4. iff any *live* row moved, one scoped ``reason="reshard"``
             fence covers exactly the surviving workers that lost live
             rows, draining their in-flight dispatches and bumping their
             epochs.  No move ⇒ no fence: a modulo shrink is free.

        ``extra_fence_workers`` lets a caller with its own slot space (the
        device cache's batch slots) merge the old owners of *its* moved
        live rows into the same single fence.

        ``topology`` optionally installs a new worker → island partition
        over the resharded workers (islands joining/leaving live); when
        omitted and the worker count changes, any multi-island topology
        drops to flat — the caller must reinstall one that covers the new
        count (sound either way: flat fences globally within the level).

        Returns the block-table's reshard plan (moved/fenced sets).
        """
        old_num = self.config.num_workers
        validate_worker_count(new_num_workers)
        if translation is None:
            translation = self.default_translation(new_num_workers)
        validate_translation(translation, old_num, new_num_workers)
        self.tracker.remap_workers(translation, old_num, new_num_workers)
        self.fences.reshard_workers(new_num_workers, translation)
        self.alloc.reshard(new_num_workers, translation)
        plan = self.tables.reshard(new_num_workers, translation)
        plan["fence_workers"] = sorted(
            set(plan["fence_workers"])
            | {int(w) for w in extra_fence_workers
               if 0 <= int(w) < new_num_workers})
        # the old island spec cannot survive a count change (the config
        # validates islands against num_workers); it is reinstated below
        # from whatever topology the fence engine kept or was given
        self.config = self.config.replace(num_workers=new_num_workers,
                                          islands=None)
        self.reshards += 1
        if topology is not None:
            # Installed before the event and the reshard fence so
            # subscribers observe (and the fence is classified under)
            # the final island layout.
            self.set_topology(topology)
        new_topo = self.fences.topology
        self.config = self.config.replace(
            islands=None if new_topo is None else new_topo.spec)
        if self.bus.wants(TopologyChanged):
            self.bus.publish(TopologyChanged(
                old_num_workers=old_num,
                new_num_workers=new_num_workers,
                translation=tuple(int(translation[w])
                                  for w in range(old_num)),
                moved_slots=tuple(plan["moved_slots"]),
                fence_workers=tuple(plan["fence_workers"]),
                islands=None if new_topo is None else new_topo.spec))
        if plan["fence_workers"]:
            mask = 0
            for w in plan["fence_workers"]:
                mask |= int(worker_bit(w))
            self.fences.fence_scoped("reshard",
                                     max(1, len(plan["moved_live_slots"])),
                                     worker_mask=mask)
        return plan

    # ===================================================================== alloc
    def _acquire(self, n: int, ctx_id: int, worker: int) -> BlockLease:
        """Allocate n order-0 blocks, applying FPR allocation-phase checks.

        One batched allocator call + one vectorised tracking pass — the
        engine hot path never loops over blocks in Python.
        """
        lease = self.alloc.acquire(n, worker_id=worker)
        if lease.blocks:
            self._allocation_checks(
                np.asarray(lease.blocks, dtype=np.int64), ctx_id, worker)
        return lease

    def _allocation_checks(self, arr: np.ndarray, ctx_id: int,
                           worker: int = 0) -> None:
        """§IV-A: fence *now* iff a block is leaving a foreign recycling
        context and no covering fence intervened since it was freed.

        Covering means either a *global* fence after the free (§IV-C5,
        ``vers < epoch``) or — scoped path — a fence over every worker in
        the block's presence mask (``worker_epochs[w] > vers`` for all
        stale candidates).  A required fence is scoped to the union of the
        still-stale workers; ALWAYS_FLUSH blocks (§IV-C4 merge conflicts)
        keep forcing a global fence.
        """
        st, eng, tr = self.stats, self.fences, self.tracker
        ids = tr.ctx_ids(arr)
        vers = tr.versions(arr)
        flags = tr.flags_of(arr)
        cur_epoch = np.uint64(eng.epoch)

        always = (flags & FLAG_ALWAYS_FLUSH) != 0
        was_shared = (flags & FLAG_WAS_SHARED) != 0
        foreign = (ids != 0) & (ids != ctx_id)
        global_ok = vers < cur_epoch            # global fence since free
        stale = eng.stale_masks(tr.worker_masks(arr), vers)
        scoped_ok = stale == 0                  # every stale worker fenced
        must_fence = always | (foreign & ~global_ok & ~scoped_ok)
        elide_global = foreign & ~always & global_ok
        elide_scope = foreign & ~always & ~global_ok & scoped_ok
        recycled = (ids != 0) & (ids == ctx_id)

        st.allocs += len(arr)
        st.recycled_hits += int(recycled.sum())
        st.clean_allocs += int((ids == 0).sum())
        st.context_exits += int(foreign.sum()) + int((always & ~foreign).sum())

        if elide_global.any():
            eng.note_version_elision(int(elide_global.sum()))
        if elide_scope.any():
            eng.note_scope_elision(int(elide_scope.sum()))
        averted = recycled | elide_global | elide_scope
        if averted.any() and not must_fence.any():
            # every deferred invalidation in this batch resolved fence-free
            # (in-context recycling or §IV-C5/scope elision) — the whole
            # merged broadcast the baseline would have sent is spared
            eng.note_fence_averted()
        if must_fence.any():
            # One merged fence covers every exiting block in this batch.
            if always.any():
                # merge-conflict blocks have unreliable tracking → global
                eng.stats.elided_always_flush += int(always.sum())
                eng.fence("context_exit", int(must_fence.sum()))
            else:
                mask = int(np.bitwise_or.reduce(stale[must_fence]))
                eng.fence_scoped("context_exit", int(must_fence.sum()),
                                 worker_mask=mask)
        if was_shared.any():
            # First reuse after a sharing exit: account how the exit was
            # covered (the "page left its recycling cycle" fence vs. a
            # legitimate §IV-C5 / scoped elision).
            ps = self.prefix_stats
            ps.exit_fenced += int((was_shared & must_fence).sum())
            ps.exit_elided += int(
                (was_shared & (elide_global | elide_scope)).sum())
        # Defensive invariant: a block inside a sharing set (refcount > 0)
        # must never reach the allocator — the release guard raises first,
        # so this counter staying 0 is the asserted "zero fences while a
        # block stays inside one sharing set" witness.
        live_rc = tr.refcounts(arr)
        if (live_rc > 0).any():
            self.prefix_stats.in_set_violations += int((live_rc > 0).sum())
        if recycled.any() and self.bus.wants(BlocksRecycled):
            self.bus.publish(BlocksRecycled(ctx_id=ctx_id,
                                            n_blocks=int(recycled.sum()),
                                            worker=worker))
        n_exits = int(foreign.sum()) + int((always & ~foreign).sum())
        if n_exits and self.bus.wants(ContextExit):
            self.bus.publish(ContextExit(
                ctx_id=ctx_id, n_blocks=n_exits,
                fenced=bool(must_fence.any()),
                elided_by_version=int(elide_global.sum()),
                elided_by_scope=int(elide_scope.sum())))
        # Stamp the new owner (0 for non-FPR use, §IV-A), clear flags.
        tr.set_many(arr, ctx_id=ctx_id, version=0, flags=0)
        # Worker presence: a block whose staleness was just covered (fenced
        # or elided) restarts from the allocating worker alone; a block
        # handed over *without* a fence (same-context recycling) must keep
        # its prior holders — they may still cache the translation, and a
        # later context exit has to fence them too.
        bit = worker_bit(worker)
        covered = must_fence | elide_global | elide_scope
        tr.set_worker_masks(
            arr, np.where(covered, bit, tr.worker_masks(arr) | bit))

    # ===================================================================== mmap
    def mmap(self, n_blocks: int, ctx: RecyclingContext | None = None, *,
             worker: int = 0, fixed_logical: int | None = None,
             prefix_hashes=None) -> Mapping:
        """Create a mapping of ``n_blocks`` logical blocks, all resident.

        ``prefix_hashes`` (chain hashes of the request's *full* prompt
        blocks, see :func:`repro_torch.core.prefix.block_hashes`) turns on prefix
        sharing for this mapping: the leading run of already-indexed hashes
        attaches to the existing shared blocks (refcount bump, **no
        allocation, no fence** — the blocks never left their sharing set),
        only the remainder is acquired fresh, and the fresh hashed blocks
        are entered into the index for future sharers.  Requires FPR with
        a real recycling context; a ``fixed_logical`` mapping never shares
        (its forced-fence semantics are per-mapping).
        """
        ctx_id = ctx.ctx_id if (ctx is not None and self.fpr_enabled) else 0
        hashes = tuple(prefix_hashes) if prefix_hashes else ()
        sharing = (self.prefix_sharing and ctx_id != 0
                   and fixed_logical is None and bool(hashes))
        shared: list = []
        if sharing:
            self.prefix_stats.lookups += 1
            shared = self.prefix.match(hashes)[:n_blocks]
            if shared:
                self.tracker.incref_many(
                    np.asarray(shared, dtype=np.int64), worker)
                self.prefix_stats.hit_blocks += len(shared)
        lease = self._acquire(n_blocks - len(shared), ctx_id, worker)
        phys = shared + list(lease.blocks)
        m = self.tables.create_mapping(phys, ctx_id=ctx_id,
                                       fixed_logical=fixed_logical,
                                       worker=worker)
        m.lease = lease
        if sharing:
            for i, b in enumerate(shared):
                self.prefix.attach(b, m.mapping_id)
                m.shared_idx.add(i)
            # Index the fresh blocks that complete the hashed prefix: the
            # owner's prefill writes their content, and later requests with
            # the same prefix attach to them.
            fresh_hashed = []
            for i in range(len(shared), min(len(hashes), n_blocks)):
                if hashes[i] in self.prefix:
                    # A mid-chain entry survived its predecessor's exit
                    # (eviction de-indexes one block at a time), so this
                    # hash is still owned by another sharing set the match
                    # couldn't reach.  Keep the rest of the run private.
                    break
                self.prefix.insert(hashes[i], phys[i], m.mapping_id)
                m.shared_idx.add(i)
                fresh_hashed.append(phys[i])
            if fresh_hashed:
                self.tracker.incref_many(
                    np.asarray(fresh_hashed, dtype=np.int64), worker)
                self.prefix_stats.miss_blocks += len(fresh_hashed)
                # the lease now contains refcounted blocks: only this
                # manager's munmap/evict paths may release them
                lease.manager = self
            m.prefix_hits = len(shared)
            if shared and self.bus.wants(BlocksShared):
                self.bus.publish(BlocksShared(ctx_id=ctx_id,
                                              n_blocks=len(shared),
                                              worker=worker,
                                              mapping_id=m.mapping_id))
        if fixed_logical is not None:
            # §IV-B: a user-forced address cannot rely on monotonic-VA ABA
            # protection — comply with the request but fence immediately.
            self.fences.fence("fixed_address", n_blocks)
        return m

    def mmap_sparse(self, n_blocks: int, ctx: RecyclingContext | None = None,
                    *, worker: int = 0) -> Mapping:
        """A mapping with no resident blocks (large file mmap; faulted lazily)."""
        if n_blocks > self.tables.max_blocks_per_seq:
            raise ValueError(f"mapping of {n_blocks} blocks exceeds "
                             f"max_blocks_per_seq={self.tables.max_blocks_per_seq}")
        ctx_id = ctx.ctx_id if (ctx is not None and self.fpr_enabled) else 0
        m = self.tables.create_mapping([], ctx_id=ctx_id, worker=worker)
        # reserve logical ids + table rows lazily via touch()
        m.physical = [NOT_RESIDENT] * n_blocks
        self.tables.ids.take(n_blocks)
        row = self.tables.table[self.tables.slot_of[m.mapping_id]]
        row[:n_blocks] = NOT_RESIDENT
        return m

    def extend(self, mapping_id: int, n_blocks: int, *, worker: int = 0
               ) -> list[int]:
        """Decode-path growth: append fresh blocks (fresh logical ids)."""
        m = self.tables.mappings[mapping_id]
        phys = list(self._acquire(n_blocks, m.ctx_id, worker).blocks)
        self.tables.extend_mapping(mapping_id, phys)
        return phys

    # =========================================================== prefix sharing
    def _detach_shared(self, block: int, mapping_id: int) -> tuple:
        """Detach one sharer from an indexed block.

        Returns ``(exited, was_orphan, newly_orphaned)``.  On exit (last
        sharer left) the block is de-indexed, its refcount hits 0, and the
        packed tracking word gets ``FLAG_WAS_SHARED`` so the allocation
        checks can account the first reuse; the caller then sends it down
        the ordinary free path.  A non-exit detach changes nothing about
        the block's residency — in particular it fences nothing.
        """
        res = self.prefix.detach(block, mapping_id)
        self.tracker.decref(block)
        if res.exited:
            self.tracker.set(
                block, flags=self.tracker.flags(block) | FLAG_WAS_SHARED)
            self.tracker.set_sharer_mask(block, 0)
            self.prefix_stats.sharing_exits += 1
        else:
            self.prefix_stats.shared_detaches += 1
        return res.exited, res.was_orphan, res.newly_orphaned

    def cow(self, mapping_id: int, logical_idx: int, *, worker: int = 0
            ) -> tuple | None:
        """Copy-on-write divergence: give the mapping a private block.

        Called by the serving layer before a divergent write into a block
        the mapping only *shares*.  Allocates a fresh block through the
        normal allocation-phase checks, repoints the mapping's table row,
        and detaches from the old block — which **stays resident inside
        its sharing set** for the remaining sharers, so no fence is needed
        (readers through a not-yet-refreshed row see the old block, whose
        content is the common prefix either way).  Returns ``(old, new)``
        physical blocks, or ``None`` if the block needs no copy (private,
        or this mapping is its only sharer — an in-place write diverges
        nobody).  The caller copies the KV rows old → new.
        """
        m = self.tables.mappings[mapping_id]
        if logical_idx not in m.shared_idx:
            return None
        old = m.physical[logical_idx]
        if old < 0 or not self.prefix.is_indexed(old):
            m.shared_idx.discard(logical_idx)    # stale after evict-exit
            return None
        if self.tracker.refcount(old) < 2:
            return None
        [new] = self._acquire(1, m.ctx_id, worker).blocks
        exited, was_orphan, newly_orphaned = \
            self._detach_shared(old, mapping_id)
        m.physical[logical_idx] = new
        m.shared_idx.discard(logical_idx)
        self.tables.table[self.tables.slot_of[mapping_id], logical_idx] = new
        self.prefix_stats.cow_copies += 1
        if newly_orphaned and self.bus.wants(SharingExit):
            self.bus.publish(SharingExit(n_blocks=0, orphaned=0,
                                         newly_orphaned=1, reason="cow"))
        return old, new

    # =================================================================== munmap
    def munmap(self, mapping_id: int, *, worker: int = 0) -> None:
        m = self.tables.mappings[mapping_id]
        rows = self.tables.destroy_mapping(mapping_id)
        if self.bus.wants(SwapDropped):
            for idx, b in enumerate(rows):
                if b == SWAPPED:        # dying mapping's swapped contents
                    self.bus.publish(SwapDropped(mapping_id=mapping_id,
                                                 logical_idx=idx))
        phys: list = []
        exits = orphaned = newly_orphaned = 0
        for idx, b in enumerate(rows):
            if b < 0:
                continue
            if idx in m.shared_idx and self.prefix.is_indexed(b):
                exited, was_orph, new_orph = self._detach_shared(b, mapping_id)
                if exited:
                    # last sharer: the block leaves its sharing set and
                    # rejoins the ordinary recycling machinery below
                    phys.append(b)
                    exits += 1
                    orphaned += int(was_orph)
                else:
                    # still shared: stays resident, fence-free — the
                    # remaining sharers' mappings keep it live
                    newly_orphaned += int(new_orph)
            else:
                phys.append(b)
        if (exits or newly_orphaned) and self.bus.wants(SharingExit):
            self.bus.publish(SharingExit(n_blocks=exits, orphaned=orphaned,
                                         newly_orphaned=newly_orphaned,
                                         reason="munmap"))
        self.stats.frees += len(phys)
        if phys:
            arr = np.asarray(phys, dtype=np.int64)
            if m.ctx_id != 0:
                # FPR: skip the fence, stamp the fence counter (§IV-A,
                # §IV-C5; == the global epoch when scoping is off).  The
                # worker-presence mask is *kept* — it is the record of who
                # may still hold a stale translation (for an ex-shared
                # block that is the union of every former sharer's bit).
                self.fences.note_skipped_free(len(phys))
                self.tracker.set_versions(arr, self.fences.seq)
            else:
                # Stock Linux: one batched shootdown per munmap — scoped
                # to the workers that actually held the translations.
                mask = int(np.bitwise_or.reduce(
                    self.tracker.worker_masks(arr)))
                self.fences.fence_scoped("munmap", len(phys),
                                         worker_mask=mask)
                self.tracker.set_worker_masks(arr, 0)   # flushed
            self.alloc.release(phys, worker_id=worker)

    # ============================================================== fault / touch
    def touch(self, mapping_id: int, logical_idx: int, *, worker: int = 0
              ) -> tuple[int, bool]:
        """Access a block; fault it in if non-resident.

        Returns (physical_block, faulted).  The eviction daemon must have been
        consulted by the caller (engine step) to keep free blocks available.
        """
        m = self.tables.mappings[mapping_id]
        b = m.physical[logical_idx]
        if b >= 0:
            # presence stamp: this worker now holds the translation
            self.tracker.add_worker(b, worker)
            return b, False
        self.stats.faults += 1
        was_swapped = b == SWAPPED
        if was_swapped:
            self.stats.swap_ins += 1
        [nb] = self._acquire(1, m.ctx_id, worker).blocks
        m.physical[logical_idx] = nb
        self.tables.table[self.tables.slot_of[mapping_id], logical_idx] = nb
        if was_swapped and self.on_swap_in is not None:
            self.on_swap_in(mapping_id, logical_idx, nb)
        return nb, True

    # ================================================================== eviction
    def evict(self, victims: list[tuple[int, int]], *, fpr_batch: bool,
              worker: int = 0) -> int:
        """Evict (mapping_id, logical_idx) blocks; returns #blocks freed.

        ``fpr_batch=False`` — stock path: one fence per call (callers batch 32).
        ``fpr_batch=True``  — §IV-B huge-batch path: one merged fence for the
        whole batch, versions stamped *before* the fence so that later
        context-exit allocations of these blocks elide their fence.

        Shared blocks are **pinned**: a victim block with other live
        sharers (refcount ≥ 2) is skipped — evicting it would tear pages
        out from under running sharers (and a preempted sharer must never
        free shared blocks).  A block whose *only* sharer is the victim
        mapping first exits its sharing set (de-indexed, ``reason="evict"``)
        and is then evicted normally.
        """
        freed: list[int] = []
        exits = orphaned = 0
        for mid, idx in victims:
            m = self.tables.mappings.get(mid)
            if m is None:
                continue
            b = m.physical[idx]
            if b < 0:
                continue
            rc = self.tracker.refcount(b)
            if rc >= 2:
                self.prefix_stats.evict_pinned += 1
                continue
            if rc == 1 and self.prefix.is_indexed(b):
                _, was_orph, _ = self._detach_shared(b, mid)
                m.shared_idx.discard(idx)
                exits += 1
                orphaned += int(was_orph)
            if self.on_swap_out is not None:
                self.on_swap_out(mid, idx, b)
            m.physical[idx] = SWAPPED
            self.tables.table[self.tables.slot_of[mid], idx] = SWAPPED
            freed.append(b)
            self.stats.swap_outs += 1
        if exits and self.bus.wants(SharingExit):
            self.bus.publish(SharingExit(n_blocks=exits, orphaned=orphaned,
                                         newly_orphaned=0, reason="evict"))
        if not freed:
            return 0
        arr = np.asarray(freed, dtype=np.int64)
        # Stamp versions first: the merged fence below then covers these
        # blocks forever (until re-allocated), enabling §IV-C5/per-worker
        # elision.  The fence is scoped to the union of the victims'
        # presence masks — only those workers can hold stale translations.
        self.tracker.set_versions(arr, self.fences.seq)
        mask = int(np.bitwise_or.reduce(self.tracker.worker_masks(arr)))
        self.fences.fence_scoped("evict_batch" if fpr_batch else "evict",
                                 len(freed), worker_mask=mask)
        self.tracker.set_worker_masks(arr, 0)           # flushed by the fence
        self.alloc.release(freed, worker_id=worker)
        return len(freed)

    # =================================================================== helpers
    @property
    def free_blocks(self) -> int:
        return self.alloc.free_blocks

    @property
    def num_blocks(self) -> int:
        return self.alloc.num_blocks

