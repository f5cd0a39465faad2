"""Capacity ledger — the admission-phase accounting behind the governor.

The paper moves the shootdown check from release time to **allocation
time** (§IV-A); the governor moves the *capacity* check one phase earlier
still, to **admission** time: a sequence is only admitted when the pool can
hold its whole attention window, so the demand pager's fixpoint scan in
``Engine.step`` always has a resident placement to converge to.  The
ledger is the bookkeeping for that invariant: committed window blocks per
pool (and per worker shard, for balance/diagnostics), with reservations
refused — not silently shrunk — when they would over-commit.

``overcommit_ratio > 1`` relaxes the invariant into vLLM-style optimism:
admissions may over-commit the pool by that factor, and the *preemption*
path (``MemoryGovernor`` victim strategies) restores soundness under
pressure instead of the admission refusal.  ``overcommit_ratio = 1`` (the
default) makes "committed ≤ capacity" a hard invariant and pager give-ups
impossible.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class CapacityError(RuntimeError):
    """An admission/reservation would over-commit the block pool."""


@dataclass
class LedgerEntry:
    blocks: int
    worker: int


@dataclass
class CapacityLedger:
    """Committed attention-window blocks per pool / worker shard.

    ``capacity`` is the physical pool size; ``limit`` is what admissions
    may commit against (``capacity × overcommit_ratio``).  Every admitted
    sequence holds one reservation for its full window (prompt +
    ``max_new_tokens``, in blocks) from admission until completion or
    preemption — the conservative bound that guarantees the demand pager a
    fixpoint whenever ``committed ≤ capacity``.
    """

    capacity: int
    num_workers: int = 1
    overcommit_ratio: float = 1.0
    committed: int = 0
    peak_committed: int = 0
    per_worker: list[int] = field(default_factory=list)
    entries: dict[int, LedgerEntry] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError(f"capacity must be positive, got {self.capacity}")
        if self.overcommit_ratio < 1.0:
            raise ValueError("overcommit_ratio must be >= 1.0 "
                             f"(got {self.overcommit_ratio})")
        if not self.per_worker:
            self.per_worker = [0] * max(1, self.num_workers)

    @property
    def limit(self) -> int:
        return max(1, int(self.capacity * self.overcommit_ratio))

    @property
    def available(self) -> int:
        return self.limit - self.committed

    def fits(self, blocks: int) -> bool:
        return self.committed + blocks <= self.limit

    def reserve(self, rid: int, blocks: int, worker: int = 0) -> None:
        """Commit ``blocks`` for request ``rid``; raises on over-commit."""
        if rid in self.entries:
            raise ValueError(f"request {rid} already holds a reservation")
        if blocks <= 0:
            raise ValueError(f"reservation must be positive, got {blocks}")
        if not self.fits(blocks):
            raise CapacityError(
                f"admitting {blocks} blocks would commit "
                f"{self.committed + blocks} > limit {self.limit} "
                f"(pool {self.capacity})")
        w = worker % len(self.per_worker)
        self.entries[rid] = LedgerEntry(blocks, w)
        self.committed += blocks
        self.per_worker[w] += blocks
        self.peak_committed = max(self.peak_committed, self.committed)

    def grow(self, rid: int, extra_blocks: int) -> None:
        """Enlarge an existing reservation (chunked-prefill / decode-path
        ``extend``): the growth is refused — not silently clipped — when it
        would over-commit the limit, mirroring :meth:`reserve`."""
        if extra_blocks <= 0:
            raise ValueError(f"growth must be positive, got {extra_blocks}")
        e = self.entries[rid]
        if not self.fits(extra_blocks):
            raise CapacityError(
                f"growing {rid} by {extra_blocks} blocks would commit "
                f"{self.committed + extra_blocks} > limit {self.limit} "
                f"(pool {self.capacity})")
        e.blocks += extra_blocks
        self.committed += extra_blocks
        self.per_worker[e.worker] += extra_blocks
        self.peak_committed = max(self.peak_committed, self.committed)

    def shrink(self, rid: int, blocks: int) -> None:
        """Return part of a reservation without releasing it — the
        prefix-sharing reconcile path: a sequence admitted on a
        unique-block *estimate* turned out to attach more shared blocks
        than probed, so its actual unique footprint is smaller.  The
        reservation must stay positive (a running sequence always owns at
        least one private block — its active tail)."""
        if blocks <= 0:
            raise ValueError(f"shrink must be positive, got {blocks}")
        e = self.entries[rid]
        if blocks >= e.blocks:
            raise ValueError(
                f"shrinking {rid} by {blocks} would empty its reservation "
                f"of {e.blocks} blocks; release() it instead")
        e.blocks -= blocks
        self.committed -= blocks
        self.per_worker[e.worker] -= blocks

    def release(self, rid: int) -> int:
        """Return ``rid``'s reservation to the pool (completion/preemption)."""
        e = self.entries.pop(rid)
        self.committed -= e.blocks
        self.per_worker[e.worker] -= e.blocks
        return e.blocks

    def holds(self, rid: int) -> bool:
        return rid in self.entries

    def reshard(self, new_num_workers: int, translation) -> None:
        """Elastic topology change: remap per-worker commitments.

        Every live reservation's worker shard is rewritten through the
        old→new ``translation`` and the per-worker totals are rebuilt —
        total ``committed`` is untouched (capacity is a pool property, not
        a topology one), so the admission invariant survives the reshard
        unchanged.
        """
        if new_num_workers < 1:
            raise ValueError(f"need >= 1 worker, got {new_num_workers}")
        old_n = len(self.per_worker)
        per_worker = [0] * new_num_workers
        for e in self.entries.values():
            e.worker = (int(translation[e.worker]) % new_num_workers
                        if e.worker < old_n else e.worker % new_num_workers)
            per_worker[e.worker] += e.blocks
        self.per_worker = per_worker
        self.num_workers = new_num_workers

    def check(self) -> None:
        """Soundness invariant: the ledger never over-commits nor drifts."""
        total = sum(e.blocks for e in self.entries.values())
        assert total == self.committed, \
            f"ledger drift: entries sum {total} != committed {self.committed}"
        assert self.committed <= self.limit, \
            f"over-commit: {self.committed} > limit {self.limit}"
        assert all(v >= 0 for v in self.per_worker), \
            f"negative per-worker commit: {self.per_worker}"

    def counters(self) -> dict:
        return {
            "capacity": self.capacity,
            "limit": self.limit,
            "committed": self.committed,
            "peak_committed": self.peak_committed,
            "per_worker_committed": list(self.per_worker),
        }
