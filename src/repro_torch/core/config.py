"""Unified config objects for the core memory-management layer.

``FprMemoryManager`` had grown ~8 loose keyword arguments; every new knob
(worker scoping, pcp batching, buddy order) widened the sprawl and every
caller re-spelled the defaults.  :class:`FprConfig` is the single validated
carrier.  The one-release loose-kwargs compatibility window
(``from_legacy_kwargs``) has closed: constructors accept ``config=`` only
and raise ``TypeError`` on anything else.
"""

from __future__ import annotations

import dataclasses
import operator
from dataclasses import dataclass


class ConfigBase:
    """Shared helpers for the frozen config dataclasses."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class FprConfig(ConfigBase):
    """Validated configuration of an :class:`~repro_torch.core.fpr.FprMemoryManager`.

    ``scoped_fences=None`` means "respect the fence engine's own flag" —
    the manager only overrides the engine when the caller decides.

    ``num_workers`` is the *initial* worker topology; it may be changed at
    runtime through :meth:`~repro_torch.core.fpr.FprMemoryManager.reshard`
    (elastic scale up/down), which revalidates the new count through the
    same :func:`validate_worker_count` as construction.

    ``islands`` optionally partitions the workers into islands (hosts /
    NUMA domains) for two-level scoped fences — a tuple of worker-id
    tuples covering ``range(num_workers)`` exactly, normalised through
    :class:`~repro_torch.core.topology.Topology`.  ``None`` (and any flat
    single-island spec) keeps the pre-island behaviour bit for bit.
    """

    num_blocks: int = 4096
    num_workers: int = 1
    islands: "tuple | None" = None
    max_seqs: int = 4096
    max_blocks_per_seq: int = 8192
    fpr_enabled: bool = True
    scoped_fences: "bool | None" = None
    pcp_batch: int = 32
    pcp_high: int = 96
    max_order: int = 10
    # Prefix sharing: enter full-prompt-block hashes into a sharing index
    # and attach common-prefix mappings to the same physical blocks
    # (copy-on-write on divergence).  Only active under ``fpr_enabled`` —
    # a sharing exit re-enters the FPR recycling machinery.
    prefix_sharing: bool = True

    def __post_init__(self) -> None:
        if self.num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, "
                             f"got {self.num_blocks}")
        if self.max_seqs <= 0 or self.max_blocks_per_seq <= 0:
            raise ValueError("max_seqs and max_blocks_per_seq must be "
                             f"positive, got {self.max_seqs} / "
                             f"{self.max_blocks_per_seq}")
        validate_worker_count(self.num_workers)
        if self.islands is not None:
            # Validate + normalise to the serialisable spec (deferred
            # import: topology sits above tracking, below config users).
            from repro_torch.core.topology import Topology
            topo = Topology.of(self.islands, num_workers=self.num_workers)
            object.__setattr__(self, "islands",
                               None if topo.is_flat else topo.spec)
        if self.pcp_batch <= 0 or self.pcp_high < self.pcp_batch:
            raise ValueError(f"need 0 < pcp_batch <= pcp_high, got "
                             f"pcp_batch={self.pcp_batch} "
                             f"pcp_high={self.pcp_high}")
        if self.max_order < 0:
            raise ValueError(f"max_order must be >= 0, got {self.max_order}")

    def topology(self):
        """The configured :class:`~repro_torch.core.topology.Topology`, or
        ``None`` for the flat degenerate case."""
        if self.islands is None:
            return None
        from repro_torch.core.topology import Topology
        return Topology.of(self.islands, num_workers=self.num_workers)


def validate_worker_count(num_workers: int) -> int:
    """The one worker-topology validation, shared by construction and
    elastic resharding (``reshard``/``resize_workers`` funnel the new
    count through here before touching any per-worker structure).  Worker
    counts above the slot count are legal — the surplus shards are simply
    empty and allocations overflow into sibling shards under the ledgered
    overflow rules."""
    try:
        num_workers = operator.index(num_workers)   # accepts numpy ints
    except TypeError:
        raise ValueError(f"num_workers must be an integer, got "
                         f"{type(num_workers).__name__}") from None
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    return num_workers


def validate_translation(translation, old_num_workers: int,
                         new_num_workers: int) -> None:
    """Reject a malformed old→new worker translation table *before* any
    per-worker structure is mutated — a reshard must either apply fully
    or leave the stack untouched."""
    for w in range(old_num_workers):
        try:
            t = int(translation[w])
        except (IndexError, KeyError, TypeError, ValueError):
            raise ValueError(
                f"translation has no entry for old worker {w} "
                f"(need {old_num_workers} entries)") from None
        if not (0 <= t < new_num_workers):
            raise ValueError(
                f"translation maps worker {w} to {t}, outside the new "
                f"topology of {new_num_workers} workers")


__all__ = ["ConfigBase", "FprConfig", "validate_translation",
           "validate_worker_count"]
