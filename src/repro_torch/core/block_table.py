"""Logical→physical block tables with monotonic logical IDs (ABA avoidance).

Paper §IV-B: after an FPR munmap skips its shootdown, the kernel must never
hand the *same virtual address* to a new mapping, or a core holding the stale
TLB entry would silently read the wrong physical page (the ABA problem).  The
fix is monotonic virtual-address assignment: the per-process VA search pointer
only moves forward.

Serving analogue: a replica (or an in-flight dispatched step) may hold a stale
copy of a request's block table after blocks were freed without a fence.  We
therefore never reuse **logical block IDs**: every mapping of a physical block
gets a fresh, process-monotonic logical ID.  A stale table row refers to a
logical ID that is *dead* — lookups through it are detectable, never silently
aliased to a new mapping.  Forcing a specific logical ID (``MAP_FIXED``
analogue) is allowed but triggers an immediate fence, matching §IV-B.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class MonotonicIdAllocator:
    """Per-engine monotonic logical-ID source (the incrementing VA pointer)."""

    def __init__(self, start: int = 1):
        self._next = start

    def take(self, n: int = 1) -> int:
        first = self._next
        self._next += n
        return first

    @property
    def high_water(self) -> int:
        return self._next


@dataclass
class Mapping:
    """One mmap analogue: a contiguous run of logical blocks for a sequence."""

    mapping_id: int
    logical_start: int                 # first logical block id (monotonic)
    physical: list[int] = field(default_factory=list)   # logical idx → phys block
    ctx_id: int = 0                    # recycling context (0 = non-FPR)
    fixed_address: bool = False        # MAP_FIXED analogue (forced logical ids)
    # prefix sharing: logical indices whose physical block is registered in
    # the prefix index (attached hits *and* own freshly-indexed blocks);
    # munmap detaches these instead of freeing, COW removes an index on
    # divergence.  ``prefix_hits`` is how many were attached (not
    # allocated) — the admission ledger reconciles reservations with it.
    shared_idx: set = field(default_factory=set)
    prefix_hits: int = 0
    lease: object = None               # BlockLease this mapping was built from

    @property
    def num_blocks(self) -> int:
        return len(self.physical)

    def logical_ids(self) -> range:
        return range(self.logical_start, self.logical_start + len(self.physical))


class BlockTableStore:
    """All live mappings of an engine + the device-facing packed tables.

    The packed representation is what actually ships to devices: an
    ``int32[max_seqs, max_blocks_per_seq]`` physical-index table plus a table
    **epoch**.  A coherence fence bumps the epoch; replicas reject tables with
    stale epochs (this is how the "flush" manifests device-side).

    **Sharding.**  With ``num_shards > 1`` the table rows are interleaved
    across per-worker shards (slot ``s`` belongs to shard ``s % num_shards``)
    and each shard carries its *own* epoch.  A scoped fence bumps only the
    epochs of the shards it covered, so a replica holding an untouched
    shard's table keeps a valid copy across fences that could not have
    invalidated it — the device-side analogue of shooting down only the
    cores named by the presence mask (numaPTE-style replica filtering).
    A global fence bumps every shard.  ``num_shards == 1`` reproduces the
    original monolithic-epoch behaviour bit for bit.
    """

    def __init__(self, max_seqs: int, max_blocks_per_seq: int,
                 num_shards: int = 1):
        self.max_seqs = max_seqs
        self.max_blocks_per_seq = max_blocks_per_seq
        self.num_shards = max(1, num_shards)
        self.ids = MonotonicIdAllocator()
        self._next_mapping = 1
        self.mappings: dict[int, Mapping] = {}
        self.table = np.full((max_seqs, max_blocks_per_seq), -1, dtype=np.int32)
        self.slot_of: dict[int, int] = {}          # mapping_id → row slot
        # per-shard free slot lists (slot % num_shards == shard), LIFO
        self._free_slots = [
            [s for s in range(max_seqs - 1, -1, -1)
             if s % self.num_shards == sh]
            for sh in range(self.num_shards)]
        self.epoch = 1                              # bumped by fences (global)
        self.shard_epochs = np.full(self.num_shards, 1, dtype=np.int64)
        self.stale_lookups_detected = 0
        self.shard_overflows = 0       # slot taken outside the worker's shard
        self.worker_of_mapping: dict[int, int] = {}
        # Slot-overflow bookkeeping for scoped fences (see bump_epoch):
        #   _overflow_live[(worker, foreign shard)] — count of *live*
        #     overflowed mappings.  While any exist, EVERY fence covering
        #     the worker must also invalidate the foreign shard: the
        #     worker's dispatches keep capturing translations from it.
        #   _overflow_dead — (worker, foreign shard) residue of destroyed
        #     overflowed mappings: a stale device copy of the dead row may
        #     linger until ONE covering fence bumps the shard.
        self._overflow_live: dict[tuple[int, int], int] = {}
        self._overflow_dead: set[tuple[int, int]] = set()
        # Per-island replica groups: with a multi-island topology each
        # island holds a replica group of the table shards, and a scoped
        # fence only *re-uploads* the shards inside the covered islands —
        # shards the fence must bump in remote islands receive a
        # delta-propagated update instead (the numaPTE remote-shootdown
        # direction).  Epochs are bumped identically either way, so the
        # staleness check is untouched; only the accounting splits.
        self._topology = None
        self.island_bumps: "dict | None" = None

    # ---------------------------------------------------------------- islands
    def set_topology(self, topology) -> None:
        """Install the worker → island partition for replica-group
        accounting.  Flat (single-island or ``None``) drops it — no
        island counters, bit-identical to the pre-island store."""
        if topology is None or topology.is_flat:
            self._topology = None
            return
        self._topology = topology
        if self.island_bumps is None:
            self.island_bumps = {"fences_intra": 0, "fences_cross": 0,
                                 "shard_bumps_intra": 0,
                                 "shard_bumps_remote": 0}

    @property
    def topology(self):
        return self._topology

    def island_totals(self) -> "dict | None":
        """``table.island.*`` counter snapshot; ``None`` when the store
        has never run multi-island (keeps flat snapshots key-identical)."""
        if self.island_bumps is None:
            return None
        return dict(self.island_bumps)

    # ---------------------------------------------------------------- shards
    def shard_of_slot(self, slot: int) -> int:
        return slot % self.num_shards

    def shard_of_mapping(self, mapping_id: int) -> int:
        return self.shard_of_slot(self.slot_of[mapping_id])

    def shard_rows(self, shard: int) -> np.ndarray:
        """Row indices owned by ``shard`` (interleaved slot layout)."""
        return np.arange(shard % self.num_shards, self.max_seqs,
                         self.num_shards)

    def _take_slot(self, worker: int) -> int:
        """Prefer a slot in the worker's own shard; overflow to any shard."""
        pref = worker % self.num_shards
        if self._free_slots[pref]:
            return self._free_slots[pref].pop()
        for sh in range(self.num_shards):
            if self._free_slots[sh]:
                self.shard_overflows += 1
                return self._free_slots[sh].pop()
        raise RuntimeError("block-table slots exhausted")

    # ------------------------------------------------------------------ create
    def create_mapping(self, physical: list[int], ctx_id: int = 0,
                       fixed_logical: int | None = None,
                       worker: int = 0) -> Mapping:
        mid = self._next_mapping
        self._next_mapping += 1
        if fixed_logical is None:
            start = self.ids.take(len(physical))
            fixed = False
        else:
            # MAP_FIXED analogue: caller forces logical ids; §IV-B requires the
            # caller (FprMemoryManager) to fence.  We still never move the
            # monotonic pointer backwards.
            start = fixed_logical
            self.ids._next = max(self.ids._next, start + len(physical))
            fixed = True
        m = Mapping(mapping_id=mid, logical_start=start,
                    physical=list(physical), ctx_id=ctx_id, fixed_address=fixed)
        self.mappings[mid] = m
        slot = self._take_slot(worker)
        self.slot_of[mid] = slot
        w = worker % self.num_shards
        self.worker_of_mapping[mid] = w
        sh = self.shard_of_slot(slot)
        if sh != w:
            self._overflow_live[(w, sh)] = (
                self._overflow_live.get((w, sh), 0) + 1)
        row = self.table[slot]
        row[:] = -1
        row[:len(physical)] = physical
        return m

    def extend_mapping(self, mapping_id: int, physical: list[int]) -> None:
        """Grow a live mapping (decode appends blocks); fresh logical ids."""
        m = self.mappings[mapping_id]
        self.ids.take(len(physical))
        base = m.num_blocks
        m.physical.extend(physical)
        if m.num_blocks > self.max_blocks_per_seq:
            raise RuntimeError("mapping exceeds max_blocks_per_seq")
        self.table[self.slot_of[mapping_id], base:m.num_blocks] = physical

    # ----------------------------------------------------------------- destroy
    def destroy_mapping(self, mapping_id: int) -> list[int]:
        """munmap analogue: returns the physical blocks for the allocator."""
        m = self.mappings.pop(mapping_id)
        slot = self.slot_of.pop(mapping_id)
        w = self.worker_of_mapping.pop(mapping_id, None)
        sh = self.shard_of_slot(slot)
        if w is not None and sh != w:
            # The live overflow record retires into dead residue: a stale
            # device copy of the row exists until a fence covering the
            # worker bumps the shard, at which point bump_epoch drops it.
            n = self._overflow_live.get((w, sh), 0) - 1
            if n > 0:
                self._overflow_live[(w, sh)] = n
            else:
                self._overflow_live.pop((w, sh), None)
            self._overflow_dead.add((w, sh))
        self.table[slot, :] = -1
        self._free_slots[sh].append(slot)
        return m.physical

    # ------------------------------------------------------------------ lookup
    def lookup(self, mapping_id: int, logical_block: int,
               table_epoch: int | None = None) -> int:
        """Translate through a (possibly stale) table copy.

        A lookup via a dead mapping or a stale epoch raises/flags rather than
        silently aliasing — this is the testable ABA guarantee.
        """
        m = self.mappings.get(mapping_id)
        if m is None:
            self.stale_lookups_detected += 1
            raise StaleMappingError(f"mapping {mapping_id} is dead")
        if table_epoch is not None:
            # the reader holds a copy of the *shard* this row lives in — a
            # scoped fence that never touched the shard leaves it valid
            cur = int(self.shard_epochs[self.shard_of_mapping(mapping_id)])
            if table_epoch < cur:
                self.stale_lookups_detected += 1
                raise StaleMappingError(
                    f"table epoch {table_epoch} < current {cur}")
        idx = logical_block - m.logical_start
        if not (0 <= idx < m.num_blocks):
            self.stale_lookups_detected += 1
            raise StaleMappingError(
                f"logical block {logical_block} outside mapping {mapping_id}")
        return m.physical[idx]

    # ------------------------------------------------------------------- fence
    def bump_epoch(self, shards=None) -> int:
        """Invalidate device copies: all shards (global fence) or only the
        listed shard/worker ids (scoped fence).  Returns the new ordinal.

        The monotonic ``epoch`` counts *every* fence; ``shard_epochs[s]`` is
        the ordinal of the last fence that covered shard ``s`` — a table copy
        of shard ``s`` is stale iff its epoch is below ``shard_epochs[s]``.
        """
        self.epoch += 1
        if shards is None:
            self.shard_epochs[:] = self.epoch
            # Dead residue is flushed; live records must survive — the
            # mappings still sit in foreign shards, and every LATER fence
            # covering their worker has to invalidate those shards again.
            self._overflow_dead.clear()
        else:
            covered = {int(s) % self.num_shards for s in np.atleast_1d(shards)}
            # A covered worker's rows may live in foreign shards (slot
            # overflow) — those shards hold translations the worker's
            # dispatches captured, so the fence must invalidate them too.
            # Live records are kept: as long as the overflowed mapping is
            # alive, a copy of its shard taken after this fence can go
            # stale again, so the NEXT covering fence must hit the shard
            # as well.  Only dead residue is one-shot.
            extra = {sh for (w, sh) in self._overflow_live if w in covered}
            extra |= {sh for (w, sh) in self._overflow_dead if w in covered}
            bumped = covered | extra
            # Residue is extinguished by ANY bump of its shard: the dead
            # row was cleared at destroy time, so copies taken after this
            # bump hold nothing stale, and copies from before it now fail
            # the epoch check.
            self._overflow_dead = {k for k in self._overflow_dead
                                   if k[1] not in bumped}
            idx = np.asarray(sorted(bumped), dtype=np.int64)
            self.shard_epochs[idx] = self.epoch
            if self._topology is not None:
                # Replica-group split: shards inside the covered islands
                # re-upload in full; shards the overflow bookkeeping pulls
                # in from *remote* islands take the delta-propagation path
                # (same epoch bump, cheaper transfer — counted apart so
                # the cross-island win is measurable).
                t = self._topology
                cov_isl = {t.island_of(s) for s in covered}
                stats = self.island_bumps
                if len(cov_isl) <= 1:
                    stats["fences_intra"] += 1
                else:
                    stats["fences_cross"] += 1
                for sh in bumped:
                    if t.island_of(sh) in cov_isl:
                        stats["shard_bumps_intra"] += 1
                    else:
                        stats["shard_bumps_remote"] += 1
        return self.epoch

    # ---------------------------------------------------------------- reshard
    def reshard(self, new_num_shards: int, translation) -> dict:
        """Remap the interleaved shard layout onto a new worker count.

        No mapping is dropped and no slot changes its row — only the
        *shard* identity of each slot moves (slot ``s`` belongs to shard
        ``s % num_shards``, and ``num_shards`` just changed).  Carried
        state, each in its sound direction (see ``shootdown.py``):

          * ``shard_epochs[s']`` = **max** over the old shards whose slots
            land in ``s'`` (epochs invalidate copies: max keeps every
            stale copy stale; a spuriously invalidated valid copy costs a
            refresh, never a wrong read);
          * free-slot lists are repartitioned by the new modulo (LIFO
            order rebuilt descending, matching construction);
          * ``worker_of_mapping`` is rewritten through ``translation`` and
            the overflow-record bookkeeping is recomputed from the live
            mappings; dead residue ``(w, sh)`` spreads to every new shard
            that inherited a slot of old shard ``sh`` (the dead row's slot
            is unknown — conservative, one covering fence retires it).

        Returns ``{"moved_slots": [...], "fence_workers": [...]}`` —
        the slots whose (translated) shard owner changed, and the
        pre-existing new-topology workers that must be covered by the
        caller's scoped ``reason="reshard"`` fence because they held live
        rows that moved away from them.
        """
        old_num = self.num_shards
        new_num = max(1, int(new_num_shards))
        trans = [int(translation[w]) for w in range(old_num)]
        # --- moved rows: the slot's (translated) owner changed ------------
        slots = np.arange(self.max_seqs)
        old_owner = np.asarray([trans[s % old_num] for s in slots])
        new_owner = slots % new_num
        moved = slots[old_owner != new_owner]
        live_slots = set(self.slot_of.values())
        moved_live = [int(s) for s in moved if int(s) in live_slots]
        # the scoped fence covers the (translated) old owners that LOST a
        # live row; brand-new workers gaining rows need data, not
        # invalidation, and can never appear here — old_owner values are
        # translation outputs, i.e. always surviving workers
        fence_workers = sorted({int(old_owner[s]) for s in moved_live})
        # old shard sh's slots {sh, sh+old, …} land in these new shards —
        # used both for the epoch max-merge and the residue translation
        spread = {sh: {int(s) % new_num
                       for s in range(sh, self.max_seqs, old_num)}
                  for sh in range(old_num)}
        # --- shard epochs: max over contributing old shards ---------------
        new_epochs = np.full(new_num, 1, dtype=np.int64)
        for sh in range(old_num):
            for t in spread[sh]:
                new_epochs[t] = max(int(new_epochs[t]),
                                    int(self.shard_epochs[sh]))
        # --- free lists: repartition by the new modulo ---------------------
        free = sorted(s for s in range(self.max_seqs)
                      if s not in live_slots)
        new_free = [[s for s in reversed(free) if s % new_num == sh]
                    for sh in range(new_num)]
        # --- overflow records (recorded worker ids are always < old_num,
        # they were stored modulo the shard count) -------------------------
        new_dead = {(trans[w], t) for (w, sh) in self._overflow_dead
                    for t in spread[sh]}
        self.num_shards = new_num
        self.shard_epochs = new_epochs
        self._free_slots = new_free
        self._overflow_dead = new_dead
        new_worker_of = {}
        new_live: dict[tuple[int, int], int] = {}
        for mid, w in self.worker_of_mapping.items():
            nw = trans[w]
            new_worker_of[mid] = nw
            sh = self.slot_of[mid] % new_num
            if sh != nw:
                new_live[(nw, sh)] = new_live.get((nw, sh), 0) + 1
        self.worker_of_mapping = new_worker_of
        self._overflow_live = new_live
        if self._topology is not None and self._topology.num_workers != new_num:
            # The old partition no longer covers the shard set; drop to
            # flat until the caller installs the reshaped topology.
            self._topology = None
        return {"moved_slots": [int(s) for s in moved],
                "moved_live_slots": moved_live,
                "fence_workers": fence_workers}

    def packed(self, shard: int | None = None) -> tuple[np.ndarray, int]:
        """The device-shippable table + its epoch.

        With ``shard`` given, only that shard's rows (a view) + its epoch —
        what a scoped fence actually has to rebroadcast.
        """
        if shard is None:
            return self.table, self.epoch
        sh = shard % self.num_shards
        return self.table[self.shard_rows(sh)], int(self.shard_epochs[sh])

    @property
    def live_mappings(self) -> int:
        return len(self.mappings)


class StaleMappingError(RuntimeError):
    """A stale (post-free) translation was used — detected, not silent."""
