"""Per-block tracking data — the paper's §IV-A/§IV-C6 recycling metadata.

The paper attaches 8 bytes to every physical page frame:

    2 bits  flags       (ALWAYS_FLUSH, reserved)
    22 bits recycling-context id   (0 == "no recycling expected" / non-FPR)
    40 bits version     (global shootdown-counter sample, taken at free time)

We keep the identical packed layout — one ``uint64`` per physical KV-cache
block, stored in a single numpy array so the footprint really is 8 bytes per
block (0.2%-ish of a 4 KiB-equivalent block, matching the paper's overhead
claim).  All operations are vectorised so the tracking cost on the engine hot
path stays negligible (§V-C measures ≤1% overhead; see benchmarks/overhead.py).

**Worker-presence bitmask (scoped fences).**  Alongside the paper's 8 bytes
we keep a second ``uint64`` per block: a bitmask of the *workers* (per-worker
free lists ≈ cores) that mapped or touched the block since its translations
were last flushed.  This is the serving analogue of per-core TLB-presence
tracking (numaPTE-style shootdown filtering): when a block leaves its
recycling context, only the workers in its mask can hold a stale
translation, so the coherence fence is scoped to them
(:meth:`repro_torch.core.shootdown.FenceEngine.fence_scoped`) instead of
broadcasting to every replica.  The mask is stamped at allocation and on
touch, survives an FPR free (that is exactly the staleness record), and is
reset to the new owner's bit once the allocation-phase checks have fenced
or elided.  Workers ≥ 63 share the top bit (conservative aliasing: a set
top bit scopes the fence to all high workers).

**Hierarchical island summary bits.**  Under a multi-island topology
(:mod:`repro_torch.core.topology`) each block additionally carries one summary
bit per *island* — set whenever any member worker's presence bit is set,
maintained incrementally on touch/attach and recomputed from the worker
mask on every reset/remap.  The summary is conservative by construction
(a clear bit proves no member worker holds a translation; a set bit
claims nothing stronger than "some member might"), which is what lets
the two-level fence engine and the per-island replica groups consult it
without ever eliding a fence the per-worker mask would have required.
Flat (single-island / no) topology keeps the summary machinery entirely
absent — zero overhead and bit-identical behaviour.
"""

from __future__ import annotations

import numpy as np

# Packed layout (LSB → MSB):  version:40 | id:22 | flags:2
_VERSION_BITS = 40
_ID_BITS = 22
_FLAG_BITS = 2

VERSION_MASK = np.uint64((1 << _VERSION_BITS) - 1)
ID_MASK = np.uint64((1 << _ID_BITS) - 1)
FLAG_MASK = np.uint64((1 << _FLAG_BITS) - 1)

_ID_SHIFT = np.uint64(_VERSION_BITS)
_FLAG_SHIFT = np.uint64(_VERSION_BITS + _ID_BITS)

#: §IV-C4 — set when two buddies with *different* non-zero recycling ids are
#: merged; a fence must always be sent when this block is next allocated.
FLAG_ALWAYS_FLUSH = 0b01

#: Prefix sharing — the formerly-reserved flag bit.  Set when a block exits
#: its *sharing set* (last sharer detached, block de-indexed and freed); read
#: and cleared by the allocation-phase checks so the manager can account how
#: the first use after a sharing exit was covered (fenced vs. legitimately
#: elided).  Lives in the paper's 8-byte word: a sharing exit is exactly
#: "page leaves its recycling cycle", so the exit marker rides the same
#: metadata that already carries the recycling state.
FLAG_WAS_SHARED = 0b10

MAX_CONTEXT_ID = (1 << _ID_BITS) - 1
MAX_VERSION = (1 << _VERSION_BITS) - 1

#: Worker ids at or above this share one mask bit (conservative aliasing).
WORKER_OVERFLOW_BIT = 63


def worker_bit(worker: int) -> np.uint64:
    """The presence-mask bit for ``worker`` (high workers alias bit 63)."""
    return np.uint64(1) << np.uint64(min(worker, WORKER_OVERFLOW_BIT))


class BlockTracker:
    """Vectorised tracking-data store for ``num_blocks`` physical blocks.

    ids are initialised to zero ("no recycling is expected", §IV-A); any
    allocation for a non-FPR use resets the id to zero.
    """

    __slots__ = ("_packed", "_worker_mask", "_refcount", "_sharer_mask",
                 "num_blocks", "_topology", "_island_mask")

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self._packed = np.zeros(num_blocks, dtype=np.uint64)
        # Worker-presence bitmask (scoped fences); kept out of the packed
        # word so the paper's 8-byte layout stays byte-identical.
        self._worker_mask = np.zeros(num_blocks, dtype=np.uint64)
        # Prefix sharing: per-block sharer refcount (number of live mappings
        # attached through the prefix index; 0 == private) and the union of
        # the sharers' worker bits.  refcount > 0 pins the block: it never
        # reaches the allocator, so no staleness can exist while a block
        # stays inside its sharing set — that is the fence-free invariant.
        self._refcount = np.zeros(num_blocks, dtype=np.int32)
        self._sharer_mask = np.zeros(num_blocks, dtype=np.uint64)
        # Hierarchical island summary bits (one bit per island over the
        # per-worker bits); only materialised for multi-island topologies
        # via set_topology — flat stays summary-free and bit-identical.
        self._topology = None
        self._island_mask: "np.ndarray | None" = None

    # -- scalar accessors ---------------------------------------------------
    def ctx_id(self, block: int) -> int:
        return int((self._packed[block] >> _ID_SHIFT) & ID_MASK)

    def version(self, block: int) -> int:
        return int(self._packed[block] & VERSION_MASK)

    def flags(self, block: int) -> int:
        return int((self._packed[block] >> _FLAG_SHIFT) & FLAG_MASK)

    def always_flush(self, block: int) -> bool:
        return bool(self.flags(block) & FLAG_ALWAYS_FLUSH)

    # -- scalar mutators ----------------------------------------------------
    def set(self, block: int, *, ctx_id: int | None = None,
            version: int | None = None, flags: int | None = None) -> None:
        p = int(self._packed[block])
        if ctx_id is not None:
            if not (0 <= ctx_id <= MAX_CONTEXT_ID):
                raise ValueError(f"ctx_id {ctx_id} out of 22-bit range")
            p = (p & ~(int(ID_MASK) << int(_ID_SHIFT))) | (ctx_id << int(_ID_SHIFT))
        if version is not None:
            p = (p & ~int(VERSION_MASK)) | (version & int(VERSION_MASK))
        if flags is not None:
            p = (p & ~(int(FLAG_MASK) << int(_FLAG_SHIFT))) | ((flags & int(FLAG_MASK)) << int(_FLAG_SHIFT))
        self._packed[block] = np.uint64(p)

    def copy_tracking(self, src: int, dst: int) -> None:
        """§IV-C4 (migration/split): copy tracking data verbatim."""
        self._packed[dst] = self._packed[src]
        self._worker_mask[dst] = self._worker_mask[src]
        if self._island_mask is not None:
            self._island_mask[dst] = self._island_mask[src]

    # -- worker-presence masks (scoped fences) --------------------------------
    def worker_mask(self, block: int) -> int:
        return int(self._worker_mask[block])

    def worker_masks(self, blocks: np.ndarray) -> np.ndarray:
        return self._worker_mask[blocks]

    def add_worker(self, block: int, worker: int) -> None:
        """Stamp worker presence on access (engine touch / fault path)."""
        self._worker_mask[block] |= worker_bit(worker)
        if self._island_mask is not None:
            self._island_mask[block] |= self._island_bit_of(worker)

    def add_worker_many(self, blocks: np.ndarray, worker: int) -> None:
        self._worker_mask[blocks] |= worker_bit(worker)
        if self._island_mask is not None:
            self._island_mask[blocks] |= self._island_bit_of(worker)

    def set_worker_masks(self, blocks: np.ndarray,
                         mask: int | np.uint64 | np.ndarray) -> None:
        """Set presence masks (scalar broadcast or per-block array)."""
        self._worker_mask[blocks] = np.asarray(mask, dtype=np.uint64)
        self.refresh_islands(blocks)

    # -- hierarchical island summary bits -------------------------------------
    def set_topology(self, topology) -> None:
        """Install the worker → island partition and (re)derive every
        block's island summary bits from its current worker mask.  A flat
        (single-island or ``None``) topology drops the summary arrays —
        the tracker behaves exactly like the pre-island one."""
        self._topology = topology
        if topology is None or topology.is_flat:
            self._topology = None
            self._island_mask = None
            return
        self._island_mask = self._islands_from_masks(self._worker_mask)

    @property
    def topology(self):
        return self._topology

    def island_mask(self, block: int) -> int:
        """The block's island summary bits (0 when no multi-island
        topology is installed)."""
        if self._island_mask is None:
            return 0
        return int(self._island_mask[block])

    def island_masks(self, blocks: np.ndarray) -> np.ndarray:
        if self._island_mask is None:
            return np.zeros(len(blocks), dtype=np.uint64)
        return self._island_mask[blocks]

    def refresh_islands(self, blocks: np.ndarray) -> None:
        """Recompute the given blocks' summary bits from their worker
        masks — the reset sites (allocation-phase mask reset) call this
        after overwriting ``_worker_mask`` directly."""
        if self._island_mask is not None:
            self._island_mask[blocks] = self._islands_from_masks(
                self._worker_mask[blocks])

    def _island_bit_of(self, worker: int) -> np.uint64:
        """Summary bit(s) for one worker; aliased (≥ 63) or out-of-
        topology workers expand conservatively to every island."""
        t = self._topology
        if worker >= WORKER_OVERFLOW_BIT or worker >= t.num_workers:
            return np.uint64((1 << t.num_islands) - 1)
        return np.uint64(1) << np.uint64(t.island_of(worker))

    def _islands_from_masks(self, masks: np.ndarray) -> np.ndarray:
        """Vectorised worker-mask → island-summary derivation: island bit
        ``i`` is set iff the mask intersects island ``i``'s worker bits;
        the aliased top bit expands to all islands."""
        t = self._topology
        out = np.zeros_like(masks)
        for i in range(t.num_islands):
            im = np.uint64(t.island_worker_mask(i))
            out |= np.where(masks & im != 0,
                            np.uint64(1) << np.uint64(i), np.uint64(0))
        top = worker_bit(WORKER_OVERFLOW_BIT)
        all_islands = np.uint64((1 << t.num_islands) - 1)
        out |= np.where(masks & top != 0, all_islands, np.uint64(0))
        return out

    # -- sharing refcounts (prefix index) -------------------------------------
    def refcount(self, block: int) -> int:
        return int(self._refcount[block])

    def refcounts(self, blocks: np.ndarray) -> np.ndarray:
        return self._refcount[blocks]

    def sharer_mask(self, block: int) -> int:
        return int(self._sharer_mask[block])

    def incref_many(self, blocks: np.ndarray, worker: int) -> None:
        """Attach one sharer to each block: bump the refcount and stamp the
        sharer's worker bit on both the sharer mask and the presence mask
        (the sharer may hold translations, so the eventual exit fence must
        be able to scope to it)."""
        self._refcount[blocks] += 1
        bit = worker_bit(worker)
        self._sharer_mask[blocks] |= bit
        self._worker_mask[blocks] |= bit
        if self._island_mask is not None:
            self._island_mask[blocks] |= self._island_bit_of(worker)

    def decref(self, block: int) -> int:
        """Detach one sharer; returns the remaining count.

        Raises on underflow — a negative refcount means a sharer was
        released twice (or a private block decref'd), which would let a
        still-shared block reach the allocator.
        """
        rc = int(self._refcount[block])
        if rc <= 0:
            raise ValueError(
                f"refcount underflow on block {block} (count {rc})")
        self._refcount[block] = rc - 1
        return rc - 1

    def set_sharer_mask(self, block: int, mask: int | np.uint64) -> None:
        """Recompute a block's sharer mask after a detach (bits cannot be
        subtracted: the manager recomputes the union over remaining
        sharers' workers)."""
        self._sharer_mask[block] = np.uint64(mask)

    def remap_workers(self, translation, old_num_workers: int,
                      new_num_workers: int) -> None:
        """Elastic reshard: rewrite every presence mask through the
        old→new worker translation table.

        A block whose mask named old worker ``w`` must afterwards name
        ``translation[w]`` — the new worker that inherited ``w``'s fence
        epoch — so later scoped fences still cover every possible stale
        holder.  The top (overflow) bit aliases all workers ≥ 63: if the
        old topology had such workers, their translations are unknowable
        per-block, so the bit conservatively expands to *every* new worker
        (the fence degenerates to global — sound, never silent).
        """
        if new_num_workers > WORKER_OVERFLOW_BIT:
            all_new = np.uint64((1 << (WORKER_OVERFLOW_BIT + 1)) - 1)
        else:
            all_new = np.uint64((1 << new_num_workers) - 1)

        def translate(old: np.ndarray) -> np.ndarray:
            new = np.zeros_like(old)
            for w in range(min(old_num_workers, WORKER_OVERFLOW_BIT)):
                bit = worker_bit(translation[w])
                new |= np.where((old >> np.uint64(w)) & np.uint64(1) != 0,
                                bit, np.uint64(0))
            if old_num_workers > WORKER_OVERFLOW_BIT:
                top = worker_bit(WORKER_OVERFLOW_BIT)
                new |= np.where(old & top != 0, all_new, np.uint64(0))
            return new

        self._worker_mask = translate(self._worker_mask)
        # Sharer masks travel the same way: a sharing exit after a reshard
        # must still scope its fence to the workers that inherited the old
        # sharers' epochs.  Refcounts are per-block and do not move.
        self._sharer_mask = translate(self._sharer_mask)
        if self._island_mask is not None:
            if self._topology.num_workers == new_num_workers:
                # Same worker count: the partition still applies — rederive
                # the summaries from the translated worker masks.
                self._island_mask = self._islands_from_masks(self._worker_mask)
            else:
                # Worker count changed: the old partition no longer covers
                # the worker set.  Drop to flat until the caller installs
                # the new topology (set_topology rederives everything).
                self._topology = None
                self._island_mask = None

    # -- vectorised views (hot path) -----------------------------------------
    def ctx_ids(self, blocks: np.ndarray) -> np.ndarray:
        return ((self._packed[blocks] >> _ID_SHIFT) & ID_MASK).astype(np.uint32)

    def versions(self, blocks: np.ndarray) -> np.ndarray:
        return self._packed[blocks] & VERSION_MASK

    def flags_of(self, blocks: np.ndarray) -> np.ndarray:
        return ((self._packed[blocks] >> _FLAG_SHIFT) & FLAG_MASK).astype(np.uint8)

    def set_many(self, blocks: np.ndarray, *, ctx_id: int,
                 version: int, flags: int = 0) -> None:
        if not (0 <= ctx_id <= MAX_CONTEXT_ID):
            raise ValueError(f"ctx_id {ctx_id} out of 22-bit range")
        packed = np.uint64((flags << int(_FLAG_SHIFT))
                           | (ctx_id << int(_ID_SHIFT))
                           | (version & int(VERSION_MASK)))
        self._packed[blocks] = packed

    def set_versions(self, blocks: np.ndarray, version: int) -> None:
        """Stamp the fence counter at free time (§IV-C5).

        With scoped fences the stamp is the engine's total fence ordinal
        (``FenceEngine.seq``); it degenerates to the paper's global epoch
        when no scoped fence ever fires (then ``seq == epoch``).
        """
        keep = self._packed[blocks] & ~VERSION_MASK
        self._packed[blocks] = keep | np.uint64(version & int(VERSION_MASK))

    # -- buddy merge semantics (§IV-C4) --------------------------------------
    def merge(self, a: int, b: int, dst: int) -> None:
        """Merge buddies ``a``/``b`` into ``dst`` (dst is a or b).

        * one tracked, one untracked  → merged block inherits the tracked data
        * both tracked, same id       → keep id, version = max(versions)
        * both tracked, different ids → ALWAYS_FLUSH flag, version = max
        """
        ia, ib = self.ctx_id(a), self.ctx_id(b)
        va, vb = self.version(a), self.version(b)
        fl = self.flags(a) | self.flags(b)
        if ia == 0 and ib == 0:
            merged_id = 0
        elif ia == 0 or ib == 0:
            merged_id = ia or ib
        elif ia == ib:
            merged_id = ia
        else:
            merged_id = min(ia, ib)  # deterministic pick; flag forces a fence
            fl |= FLAG_ALWAYS_FLUSH
        merged_mask = self._worker_mask[a] | self._worker_mask[b]
        self.set(dst, ctx_id=merged_id, version=max(va, vb), flags=fl)
        self._worker_mask[dst] = merged_mask
        if self._island_mask is not None:
            self._island_mask[dst] = (self._island_mask[a]
                                      | self._island_mask[b])

    def split(self, src: int, dst_a: int, dst_b: int) -> None:
        """Buddy split: copy tracking data to both halves (§IV-C4)."""
        packed, mask = self._packed[src], self._worker_mask[src]
        self._packed[dst_a] = packed
        self._packed[dst_b] = packed
        self._worker_mask[dst_a] = mask
        self._worker_mask[dst_b] = mask
        if self._island_mask is not None:
            imask = self._island_mask[src]
            self._island_mask[dst_a] = imask
            self._island_mask[dst_b] = imask

    def fan_out(self, head: int, count: int) -> None:
        """Broadcast the head's tracking over a contiguous run.

        Equivalent to recursively splitting the run down to order 0 —
        the batched-refill fast path hands out a whole buddy run at once
        and must leave every block carrying the run's (merged) tracking.
        """
        self._packed[head:head + count] = self._packed[head]
        self._worker_mask[head:head + count] = self._worker_mask[head]
        if self._island_mask is not None:
            self._island_mask[head:head + count] = self._island_mask[head]

    # -- misc -----------------------------------------------------------------
    def reset(self) -> None:
        """Clear all tracking (the paper clears tracking before experiments)."""
        self._packed[:] = 0
        self._worker_mask[:] = 0
        self._refcount[:] = 0
        self._sharer_mask[:] = 0
        if self._island_mask is not None:
            self._island_mask[:] = 0

    def nbytes(self) -> int:
        return self._packed.nbytes

    def tracked_count(self) -> int:
        return int(np.count_nonzero((self._packed >> _ID_SHIFT) & ID_MASK))
