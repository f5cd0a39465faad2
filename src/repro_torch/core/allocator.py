"""Physical-block allocator: buddy system + per-worker free lists.

This reproduces the Linux allocation substrate the paper builds on (§II-C):

* a global **buddy allocator** partitions the physical KV-block pool into
  power-of-two runs; splits/merges propagate FPR tracking data (§IV-C4);
* **per-worker free lists** serve order-0 (single-block) requests in a lock-free
  fast path; a worker refills/spills in batches from/to the buddy allocator.

The public surface is a single verb pair — ``acquire(n) -> BlockLease`` /
``release(lease_or_blocks)`` — on :class:`BlockAllocator`; the lease carries
blocks, worker, contiguous-run order, and (for prefix-shared blocks)
refcount ownership, so a shared block can only be released through the
memory manager.  :class:`BuddyAllocator` keeps its raw ``alloc(order)`` /
``free(head, order)`` as internal primitives.

The per-worker lists are *the reason recycling works*: back-to-back
alloc→free→alloc cycles on one worker hand back exactly the same physical
blocks, so an FPR context sees its own blocks again and no fence is needed.

The allocator itself is policy-free: it never fences.  The FPR policy
(tracking checks at allocation, version stamping at free) lives in
``repro_torch.core.fpr.FprMemoryManager``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.tracking import BlockTracker


class OutOfBlocksError(RuntimeError):
    """The pool cannot serve the request (caller should evict and retry)."""


@dataclass
class BuddyStats:
    splits: int = 0
    merges: int = 0
    slow_allocs: int = 0
    fast_allocs: int = 0
    refills: int = 0
    spills: int = 0


class BuddyAllocator:
    """Binary-buddy allocator over ``num_blocks`` physical blocks.

    Block addresses are plain indices into the physical KV cache.  The buddy
    of block ``b`` at order ``o`` is ``b ^ (1 << o)``; merging yields the
    lower-addressed head.  Tracking data propagation on split/merge follows
    §IV-C4 via :class:`BlockTracker`.
    """

    def __init__(self, num_blocks: int, tracker: BlockTracker,
                 max_order: int = 10):
        self.num_blocks = num_blocks
        self.tracker = tracker
        self.max_order = max_order
        self.free_lists: list[set[int]] = [set() for _ in range(max_order + 1)]
        # order of the free run headed at block b (only valid while free)
        self._free_order = np.full(num_blocks, -1, dtype=np.int8)
        self.stats = BuddyStats()
        self._seed(num_blocks)
        self._free_count = num_blocks

    def _seed(self, n: int) -> None:
        """Greedily cover [0, n) with the largest aligned power-of-two runs."""
        addr = 0
        while addr < n:
            order = min(self.max_order, (addr & -addr).bit_length() - 1
                        if addr else self.max_order)
            while (1 << order) > n - addr:
                order -= 1
            self.free_lists[order].add(addr)
            self._free_order[addr] = order
            addr += 1 << order

    # ------------------------------------------------------------------ alloc
    def alloc(self, order: int = 0) -> int:
        """Allocate a 2**order contiguous run; returns the head block index."""
        if order > self.max_order:
            raise OutOfBlocksError(f"order {order} exceeds max {self.max_order}")
        o = order
        while o <= self.max_order and not self.free_lists[o]:
            o += 1
        if o > self.max_order:
            raise OutOfBlocksError(
                f"no free run of order {order} (free={self._free_count})")
        head = min(self.free_lists[o])  # deterministic; favours low addresses
        self.free_lists[o].discard(head)
        self._free_order[head] = -1
        # Split down to the requested order, propagating tracking data.
        while o > order:
            o -= 1
            buddy = head + (1 << o)
            self.tracker.split(head, head, buddy)       # §IV-C4
            self.free_lists[o].add(buddy)
            self._free_order[buddy] = o
            self.stats.splits += 1
        self.stats.slow_allocs += 1
        self._free_count -= 1 << order
        return head

    # ------------------------------------------------------------------- free
    def free(self, head: int, order: int = 0) -> None:
        """Return a run to the allocator, merging buddies where possible."""
        if not (0 <= head < self.num_blocks):
            raise ValueError(f"block {head} out of range")
        if self._free_order[head] != -1:
            raise ValueError(f"double free of block {head}")
        o = head_order = order
        h = head
        while o < self.max_order:
            buddy = h ^ (1 << o)
            if buddy >= self.num_blocks or self._free_order[buddy] != o:
                break
            # merge: remove buddy from its free list, keep the lower head
            self.free_lists[o].discard(buddy)
            self._free_order[buddy] = -1
            lo, hi = (h, buddy) if h < buddy else (buddy, h)
            self.tracker.merge(lo, hi, lo)              # §IV-C4
            h = lo
            o += 1
            self.stats.merges += 1
        self.free_lists[o].add(h)
        self._free_order[h] = o
        self._free_count += 1 << head_order

    @property
    def free_blocks(self) -> int:
        return self._free_count


@dataclass
class WorkerFreeList:
    """Per-worker order-0 cache (Linux per-CPU page list analogue)."""

    worker_id: int
    batch: int = 32          # refill/spill chunk (Linux pcp batch)
    high: int = 96           # spill threshold
    blocks: deque = field(default_factory=deque)


@dataclass
class BlockLease:
    """The single allocation handle handed out by :meth:`BlockAllocator.acquire`.

    A lease carries everything :meth:`BlockAllocator.release` needs to put
    the blocks back correctly: the block indices, the worker whose list they
    came from, and — for contiguous acquisitions — the buddy order of the
    run.  ``manager`` records refcount ownership: once a memory manager has
    entered any of the lease's blocks into a sharing set (prefix index), the
    lease can no longer be released directly — shared blocks must exit
    through the manager (``munmap``/``evict``), which is what keeps the
    "refcount > 0 ⇒ never reaches the allocator" invariant airtight.
    """

    blocks: tuple
    worker_id: int = 0
    order: int | None = None           # set only for contiguous runs
    manager: object | None = None      # refcount owner; blocks release()

    def __len__(self) -> int:
        return len(self.blocks)

    def __iter__(self):
        return iter(self.blocks)


class BlockAllocator:
    """Facade: per-worker fast path over the global buddy slow path.

    The entire public surface is one verb pair: :meth:`acquire` returns a
    :class:`BlockLease`, :meth:`release` takes a lease (or a raw block
    iterable) back.  The hot path is **batched**: one ``acquire`` serves a
    whole allocation (a sequence's worth of order-0 blocks) with one refill
    decision, refilling the worker list from the buddy in the largest
    power-of-two runs available instead of block-by-block; likewise one
    ``release`` makes one spill decision per batch.
    """

    def __init__(self, num_blocks: int, tracker: BlockTracker,
                 num_workers: int = 1, max_order: int = 10,
                 pcp_batch: int = 32, pcp_high: int = 96):
        self.buddy = BuddyAllocator(num_blocks, tracker, max_order=max_order)
        self.tracker = tracker
        self.workers = [WorkerFreeList(w, batch=pcp_batch, high=pcp_high)
                        for w in range(num_workers)]
        # Optional guard installed by the memory manager: maps a block
        # array to its sharing refcounts.  release() refuses any block
        # that is still inside a sharing set.
        self.refcount_of = None

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    def reshard(self, new_num_workers: int, translation) -> None:
        """Elastic topology change: repartition the per-worker free lists.

        Old worker ``w``'s cached blocks drain into ``translation[w]``'s
        list (preserving FIFO order within each source, sources in worker
        order — deterministic), so recycling locality survives a shrink;
        brand-new workers start with empty lists and refill from the
        buddy on first allocation.
        """
        if new_num_workers < 1:
            raise ValueError(f"need >= 1 worker, got {new_num_workers}")
        batch = self.workers[0].batch if self.workers else 32
        high = self.workers[0].high if self.workers else 96
        new = [WorkerFreeList(w, batch=batch, high=high)
               for w in range(new_num_workers)]
        for wl in self.workers:
            new[int(translation[wl.worker_id]) % new_num_workers].blocks \
                .extend(wl.blocks)
        self.workers = new

    # -- the unified surface ---------------------------------------------------
    def acquire(self, n: int, *, worker_id: int = 0,
                contiguous: bool = False) -> BlockLease:
        """Allocate ``n`` blocks; returns a :class:`BlockLease`.

        Default path: ``n`` order-0 blocks off the worker's list — the ``n``
        most recently freed ones (LIFO, maximal recycling locality) — with
        at most one bulk refill from the buddy.  Raises
        :class:`OutOfBlocksError` without handing out anything if the pool
        cannot cover ``n``.

        ``contiguous=True`` allocates one aligned buddy run instead,
        rounding ``n`` up to the next power of two; the lease then carries
        the whole run (``len(lease) == 2**order >= n``) and its order, so
        release returns it to the buddy in one piece.
        """
        if n <= 0:
            return BlockLease(blocks=(), worker_id=worker_id)
        if contiguous:
            order = max(0, (n - 1).bit_length())
            head = self.buddy.alloc(order)
            if order > 0:
                self.tracker.fan_out(head, 1 << order)
            self.buddy.stats.fast_allocs += 1 << order
            return BlockLease(blocks=tuple(range(head, head + (1 << order))),
                              worker_id=worker_id, order=order)
        wl = self.workers[worker_id]
        if len(wl.blocks) < n:
            self._refill_bulk(wl, n - len(wl.blocks))
        self.buddy.stats.fast_allocs += n
        return BlockLease(blocks=tuple(wl.blocks.pop() for _ in range(n)),
                          worker_id=worker_id)

    def release(self, lease_or_blocks, *, worker_id: int | None = None) -> None:
        """Return blocks to the allocator; one spill decision per batch.

        Accepts the :class:`BlockLease` from :meth:`acquire` (preferred —
        it remembers its worker and, for contiguous runs, its order) or any
        iterable of block indices.  A lease whose ``manager`` is set is
        refused: its blocks are inside a sharing set and only the manager
        may exit them.  When a refcount guard is installed, any block with
        a live sharer refcount is refused for the same reason.
        """
        if isinstance(lease_or_blocks, BlockLease):
            lease = lease_or_blocks
            if lease.manager is not None:
                raise ValueError(
                    "lease is owned by a memory manager (shared blocks); "
                    "release it via the manager's munmap/evict path")
            blocks = lease.blocks
            if worker_id is None:
                worker_id = lease.worker_id
            order = lease.order
        else:
            blocks = tuple(int(b) for b in lease_or_blocks)
            if worker_id is None:
                worker_id = 0
            order = None
        if not blocks:
            return
        if self.refcount_of is not None:
            rc = self.refcount_of(np.asarray(blocks, dtype=np.int64))
            if (rc > 0).any():
                raise ValueError(
                    "refusing to release blocks still inside a sharing set "
                    f"(refcounts {rc.tolist()}); exit them via the manager")
        if order is not None:
            self.buddy.free(blocks[0], order)
            return
        wl = self.workers[worker_id]
        wl.blocks.extend(int(b) for b in blocks)
        if len(wl.blocks) > wl.high:
            self._spill(wl)

    def _refill_bulk(self, wl: WorkerFreeList, need: int) -> None:
        """One batched refill: pull ≥ ``need`` blocks (rounded up to the pcp
        batch for headroom) from the buddy as whole power-of-two runs,
        falling back to stealing from sibling workers when the buddy is dry.
        """
        self.buddy.stats.refills += 1
        target = max(need, wl.batch)
        got = 0
        while got < target:
            want = target - got
            order = min(self.buddy.max_order, max(0, want.bit_length() - 1))
            head = None
            while order >= 0:
                try:
                    head = self.buddy.alloc(order)
                    break
                except OutOfBlocksError:
                    order -= 1
            if head is None:
                break                      # buddy exhausted
            if order > 0:
                # a whole run is handed out at once: broadcast the head's
                # (merged) tracking as a recursive split would (§IV-C4)
                self.tracker.fan_out(head, 1 << order)
            wl.blocks.extend(range(head, head + (1 << order)))
            got += 1 << order
        if got >= need:
            return
        # last resort: steal from other workers' lists (oldest blocks first)
        for other in self.workers:
            if other is wl:
                continue
            while other.blocks and got < need:
                wl.blocks.append(other.blocks.popleft())
                got += 1
            if got >= need:
                return
        raise OutOfBlocksError(
            f"pool cannot cover {need} more blocks (got {got})")

    def _spill(self, wl: WorkerFreeList) -> None:
        self.buddy.stats.spills += 1
        for _ in range(min(wl.batch, len(wl.blocks))):
            self.buddy.free(wl.blocks.popleft(), 0)   # oldest blocks spill

    # -- pool pressure ----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return self.buddy.free_blocks + sum(len(w.blocks) for w in self.workers)

    @property
    def num_blocks(self) -> int:
        return self.buddy.num_blocks

    def drain_worker_lists(self) -> None:
        """Spill every per-worker list back to the buddy (test/teardown aid)."""
        for wl in self.workers:
            while wl.blocks:
                self.buddy.free(wl.blocks.popleft(), 0)
