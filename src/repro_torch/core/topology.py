"""Hierarchical worker topology — islands of workers (the numaPTE analogue).

numaPTE replicates page tables per NUMA node and pays migration-aware
invalidations only where a replica exists; the serving analogue groups
workers into **islands** (hosts / NUMA domains).  Each island holds a
replica group of the block tables, so the coherence machinery can pick
the narrowest level for every fence:

  * **intra-island** — the covered workers all live in one island; only
    that island's replicas refresh, at the ordinary scoped-fence cost.
  * **cross-island** — the covered set spans islands; the fence pays a
    configurable ``cross_island_cost`` multiplier (the IPI must cross
    the interconnect) and propagates as *deltas* to the remote islands'
    replicas — the remote-shootdown direction.

A :class:`Topology` is an immutable partition of ``range(num_workers)``
into non-empty islands.  The **flat** single-island topology is the
degenerate case: every fence is intra-island, no multiplier ever
applies, and every counter and modeled cost is bit-identical to the
pre-island engine — which is what lets the island machinery ride the
existing scoped-fence stack without perturbing it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.tracking import WORKER_OVERFLOW_BIT, worker_bit


@dataclass(frozen=True)
class Topology:
    """An immutable worker → island partition.

    ``islands`` is a tuple of tuples of worker ids; together they must
    partition ``range(num_workers)`` exactly (every worker in exactly
    one island, no gaps, no strays).  Construct via :meth:`flat`,
    :meth:`grid`, :meth:`of`, or directly from an island spec.
    """

    islands: tuple

    def __post_init__(self) -> None:
        try:
            norm = tuple(tuple(int(w) for w in isl) for isl in self.islands)
        except TypeError:
            raise ValueError(
                f"islands must be a sequence of worker-id sequences, "
                f"got {self.islands!r}") from None
        object.__setattr__(self, "islands", norm)
        if not norm or any(len(isl) == 0 for isl in norm):
            raise ValueError(f"islands must be non-empty, got {norm!r}")
        seen: list = sorted(w for isl in norm for w in isl)
        n = len(seen)
        if seen != list(range(n)):
            raise ValueError(
                f"islands must partition range(num_workers) exactly "
                f"(every worker in exactly one island); got workers {seen}")

    # ------------------------------------------------------------ construction
    @classmethod
    def flat(cls, num_workers: int) -> "Topology":
        """The single-island degenerate topology over ``num_workers``."""
        if num_workers < 1:
            raise ValueError(f"need >= 1 worker, got {num_workers}")
        return cls(islands=(tuple(range(int(num_workers))),))

    @classmethod
    def grid(cls, num_islands: int, workers_per_island: int) -> "Topology":
        """``num_islands`` islands of ``workers_per_island`` consecutive
        workers each — the homogeneous multi-host layout."""
        if num_islands < 1 or workers_per_island < 1:
            raise ValueError(
                f"need >= 1 island of >= 1 worker, got "
                f"{num_islands} x {workers_per_island}")
        return cls(islands=tuple(
            tuple(range(i * workers_per_island,
                        (i + 1) * workers_per_island))
            for i in range(num_islands)))

    @classmethod
    def of(cls, spec, num_workers: int | None = None) -> "Topology":
        """Normalise a topology spec: ``None`` → flat over ``num_workers``,
        an int → flat over that many workers, a :class:`Topology` →
        itself, anything else → an island spec.  When ``num_workers`` is
        given the result must cover exactly that many workers."""
        if spec is None:
            if num_workers is None:
                raise ValueError("Topology.of(None) needs num_workers")
            topo = cls.flat(num_workers)
        elif isinstance(spec, Topology):
            topo = spec
        elif isinstance(spec, (int, np.integer)):
            topo = cls.flat(int(spec))
        else:
            topo = cls(islands=tuple(spec))
        if num_workers is not None and topo.num_workers != int(num_workers):
            raise ValueError(
                f"topology covers {topo.num_workers} workers, "
                f"expected {num_workers}")
        return topo

    # -------------------------------------------------------------- properties
    @property
    def num_islands(self) -> int:
        return len(self.islands)

    @property
    def num_workers(self) -> int:
        return sum(len(isl) for isl in self.islands)

    @property
    def is_flat(self) -> bool:
        return len(self.islands) == 1

    @property
    def spec(self) -> tuple:
        """The serialisable island spec (events, configs, artifacts)."""
        return self.islands

    # ------------------------------------------------------------------ lookup
    def island_of(self, worker: int) -> int:
        """Island id of ``worker``; workers beyond the topology (observer
        workers a shared fence engine grew past it) fold through the
        modulo default rule, mirroring the epoch-table default."""
        w = int(worker)
        n = self.num_workers
        if w >= n:
            w %= n
        for i, isl in enumerate(self.islands):
            if w in isl:
                return i
        raise ValueError(f"worker {worker} not in topology")  # unreachable

    def workers_in(self, island: int) -> tuple:
        return self.islands[int(island)]

    def islands_of(self, workers) -> tuple:
        """Sorted island ids covering a worker collection."""
        return tuple(sorted({self.island_of(w) for w in workers}))

    def island_worker_mask(self, island: int) -> int:
        """Presence-mask bits of the island's workers (workers ≥ 63 alias
        the overflow bit, like :func:`~repro_torch.core.tracking.worker_bit`)."""
        mask = 0
        for w in self.islands[int(island)]:
            mask |= int(worker_bit(w))
        return mask

    def islands_of_mask(self, worker_mask: int) -> tuple:
        """Island ids present in a worker bitmask.  The aliased overflow
        bit (workers ≥ 63) expands conservatively to every island — any
        high worker could live anywhere."""
        mask = int(worker_mask)
        if mask >> WORKER_OVERFLOW_BIT & 1:
            return tuple(range(self.num_islands))
        found = set()
        for i in range(self.num_islands):
            if mask & self.island_worker_mask(i):
                found.add(i)
        return tuple(sorted(found))


__all__ = ["Topology"]
