"""MemoryGovernor — capacity-aware admission control + preemption.

Sits between :class:`~repro_torch.serving.scheduler.Scheduler` and
:class:`~repro_torch.serving.kv_cache.PagedKVCache`:

  * **admission** — a queued sequence is admitted only when the
    :class:`~repro_torch.serving.admission.ledger.CapacityLedger` can commit its
    whole attention window (prompt + ``max_new_tokens`` in blocks).  With
    the default ``overcommit_ratio = 1`` this closes the
    ``demand_pager_gave_up`` hole as a hard invariant: every set of running
    windows has a resident placement, so the pager's fixpoint scan always
    converges.  The *policy* (FCFS / recycle-affinity / priority classes)
    decides the order — recycle-affinity is the FPR-aware one: it hands
    freed blocks to the same stream's next request so recycling stays hot
    and the context-exit fence is averted.

  * **preemption** — under pressure (optimistic over-commit, or a blocked
    higher-priority request) the governor picks a victim (lowest priority
    class, then most recently admitted — vLLM's LIFO choice, which
    minimises wasted work) and the engine applies one of two strategies:

      - ``recompute`` — free the victim's mapping (the blocks recycle,
        fence-free under FPR) and re-prefill from scratch on re-admission;
      - ``swap`` — push the victim's resident blocks out through the
        watermark evictor's swap path (one merged fence, contents
        round-trip through the swap store) and keep mapping + generated
        tokens; re-admission demand-faults the blocks back in.

    Both strategies preserve decoded tokens exactly (greedy decode is
    deterministic; swap round-trips block contents bit-for-bit).

The governor is engine-agnostic bookkeeping: it never touches the cache or
scheduler itself — the engine drives both and reports back, which keeps
the policy layer (this module) cleanly separated from the mechanism layer
(core/), the split eBPF-mm argues for.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.events import (AdmissionDecision, EventBus,
                               PreemptionResolved)
from repro_torch.serving.admission.ledger import CapacityError, CapacityLedger
from repro_torch.serving.admission.policies import (AdmissionPolicy, PriorityPolicy,
                                              make_policy)
from repro_torch.serving.admission.quota import TenantQuota

PREEMPT_STRATEGIES = ("recompute", "swap")


@dataclass
class GovernorConfig:
    """Knobs for the admission/preemption subsystem.

    ``tenant_caps`` enables per-tenant quota enforcement (tenant = request
    ``stream``): a dict of tenant → max committed window blocks, with
    ``tenant_default_cap`` applying to unlisted tenants (``None`` =
    unlimited).  A tenant at its cap is skipped by admission until a
    release credits it back — see
    :class:`~repro_torch.serving.admission.quota.TenantQuota`.
    """

    policy: "str | AdmissionPolicy" = "fcfs"
    preempt: str = "recompute"          # recompute | swap
    overcommit_ratio: float = 1.0       # 1.0 = hard capacity invariant
    affinity_window: int = 8            # freed streams remembered (newest first)
    tenant_caps: "dict | None" = None   # tenant → committed-block cap
    tenant_default_cap: "int | None" = None

    def __post_init__(self) -> None:
        if self.preempt not in PREEMPT_STRATEGIES:
            raise ValueError(f"unknown preempt strategy {self.preempt!r}; "
                             f"known: {PREEMPT_STRATEGIES}")


@dataclass
class GovernorStats:
    admitted: int = 0
    rejected_overcommit: int = 0        # admission rounds refused for capacity
    holds: int = 0                      # rounds a policy held free capacity
                                        # for a starved request (deadline SLA)
    preemptions_recompute: int = 0
    preemptions_swap: int = 0
    affinity_hits: int = 0              # admission matched a freed stream
    affinity_misses: int = 0            # a freed stream was known, no match
    chunk_grows: int = 0                # reservation growths past admission
                                        # (chunked prefill / COW divergence)

    @property
    def affinity_hit_rate(self) -> Optional[float]:
        n = self.affinity_hits + self.affinity_misses
        return round(self.affinity_hits / n, 4) if n else None

    def snapshot(self) -> dict:
        d = dict(self.__dict__)
        d["affinity_hit_rate"] = self.affinity_hit_rate
        return d


class MemoryGovernor:
    """Capacity ledger + admission policy + victim selection."""

    def __init__(self, capacity_blocks: int, block_size: int, *,
                 num_workers: int = 1,
                 config: GovernorConfig | None = None,
                 bus: EventBus | None = None):
        self.config = config or GovernorConfig()
        self.block_size = block_size
        self.bus = bus if bus is not None else EventBus()
        self.ledger = CapacityLedger(
            capacity_blocks, num_workers=num_workers,
            overcommit_ratio=self.config.overcommit_ratio)
        self.policy = make_policy(self.config.policy)
        # per-tenant quota rides the AdmissionDecision stream for charging
        # and the capacity predicate for refusal (see quota.py); a bare
        # tenant_default_cap (uniform cap, no per-tenant overrides) is a
        # valid configuration and must enable enforcement too
        self.quota = (TenantQuota(self.config.tenant_caps or {},
                                  default_cap=self.config.tenant_default_cap,
                                  bus=self.bus)
                      if (self.config.tenant_caps is not None
                          or self.config.tenant_default_cap is not None)
                      else None)
        self.stats = GovernorStats()
        # SLA-aware policies consume the governor's own decision stream
        if hasattr(self.policy, "attach"):
            self.policy.attach(self.bus)
        # hold-capable policies need the starvation predicate so a
        # quota-blocked request never engages (or sustains) a hold
        if getattr(self.policy, "can_hold", False):
            self.policy.starvation_fits = self._starvable_fits
        # preemption bookkeeping is event-driven: the engine publishes
        # PreemptionResolved; virtual-time sims may call count_preempt
        # directly instead (they have no engine loop)
        self.bus.subscribe(PreemptionResolved,
                           lambda evt: self.count_preempt(evt.strategy))
        self._freed_streams: deque[str] = deque(
            maxlen=max(1, self.config.affinity_window))
        self._admit_seq = itertools.count(1)
        self._admit_order: dict[int, int] = {}      # rid → admission ordinal
        # Prefix-sharing hooks (both engine-installed, both optional):
        # ``probe_shared(r)`` returns how many leading window blocks the
        # request would attach to the live sharing index instead of
        # allocating, so admission reserves only the estimated *unique*
        # remainder (quota charging follows the same estimate).
        # ``shared_residual()`` returns the indexed live blocks covered by
        # NO running reservation (orphaned prefixes whose owner completed
        # or diverged); fits() charges them against capacity so every
        # physical block is accounted either by a reservation or by the
        # residual — the pager-fixpoint guarantee survives sharing.
        self.probe_shared = None
        self.shared_residual = None
        # Chunked-prefill admission (engine-installed): when set to the
        # chunk size in blocks, a fresh request is admitted when its first
        # chunk plus one active tail block fits — the reservation then
        # grows chunk-by-chunk through on_extend.  ``None`` keeps the
        # monolithic full-window reservation.
        self.chunk_blocks: "int | None" = None
        # Hierarchical island topology (engine-installed via reshard /
        # construction): the worker → island partition, used only to
        # aggregate per-worker ledger commitments per island in
        # counters(); None (flat) keeps counter key sets unchanged.
        self.topology = None
        # Observability hook (engine-installed): called with the queue
        # depth of every non-empty admission round — feeds the
        # ``admission.obs.queue_depth`` histogram directly, without the
        # AdmissionDecision event's blocked_rid scan (the hook stays cheap
        # even when a tracer forces bus.wants(AdmissionDecision) on).
        self.observe_queue_depth = None

    # ------------------------------------------------------------- windows
    def window_blocks(self, r) -> int:
        """Blocks to reserve for ``r``: the full attention window (prompt
        + budget), minus — when the prefix-sharing probe is installed —
        the leading blocks the request would *attach* rather than
        allocate.  At least one block is always reserved (the active
        decode tail is private even under a fully shared prompt)."""
        need = len(r.prompt) + r.max_new_tokens
        full = max(1, -(-need // self.block_size))
        if self.probe_shared is not None:
            shared = min(int(self.probe_shared(r)), full - 1)
            return max(1, full - shared)
        return full

    def admit_blocks(self, r) -> int:
        """Blocks the *admission* reserves for ``r``.

        Monolithic (``chunk_blocks is None``): the full shared-adjusted
        window.  Chunked: the first prefill chunk plus one active tail
        block — the rest is grown per chunk through :meth:`on_extend`.  A
        swap-preempted re-admission carries a surviving mapping; its
        reservation must cover the blocks that mapping actually holds
        (they fault back in full), never a fresh chunk estimate.
        """
        m = getattr(r, "mapping", None)
        if m is not None:
            return max(1, m.num_blocks - getattr(m, "prefix_hits", 0))
        full = self.window_blocks(r)
        if self.chunk_blocks is None:
            return full
        return min(full, self.chunk_blocks + 1)

    def admissible_ever(self, r) -> bool:
        """Can this request's window ever fit (even on an empty pool)?

        Deliberately the *full* shared-adjusted window even under chunked
        admission: chunks are individually small, but the full window
        still bounds the request's final residency — a window that can
        never fit would only ever grow into a guaranteed CapacityError.
        """
        return self.window_blocks(r) <= self.ledger.limit

    def fits(self, r) -> bool:
        """The admission capacity predicate: the ledger can commit the
        admission reservation (plus any unreserved shared-prefix residual)
        AND the tenant (when quotas are on) is under its cap.  Quota is
        charged on the full window estimate even under chunked admission —
        tenant caps bound final residency, not first-chunk footprints."""
        blocks = self.admit_blocks(r)
        residual = (int(self.shared_residual())
                    if self.shared_residual is not None else 0)
        if not self.ledger.fits(blocks + residual):
            return False
        return (self.quota is None
                or self.quota.allows(r.stream, self.window_blocks(r)))

    def _starvable_fits(self, r) -> bool:
        """``fits`` for starvation accounting (preemption beneficiaries,
        ``blocked_rid`` aging): a *quota*-blocked request reads as
        fitting, because freeing capacity — by preempting other tenants
        or holding admissions — can never credit its tenant's cap.  Only
        capacity-blocked requests may drive preemption or deadline
        holds."""
        if (self.quota is not None
                and not self.quota.allows(r.stream, self.window_blocks(r))):
            return True
        return self.fits(r)

    def reshard(self, new_num_workers: int, translation,
                topology=None) -> None:
        """Elastic topology change: remap the ledger's per-worker shares
        (quota caps are per-tenant, not per-worker — untouched).
        ``topology`` optionally installs the new worker → island partition
        so the counters can aggregate commitments per island; omitting it
        across a count change drops the partition to flat."""
        self.ledger.reshard(new_num_workers, translation)
        if topology is not None:
            self.topology = None if topology.is_flat else topology
        elif (self.topology is not None
              and self.topology.num_workers != new_num_workers):
            self.topology = None

    # ----------------------------------------------------------- admission
    def select(self, queue: list) -> Optional[int]:
        """Index of the next queue entry to admit, or None.

        Every round publishes one :class:`AdmissionDecision` event —
        ``"admit"`` with the chosen rid, or ``"reject"`` when a non-empty
        queue seats nothing.  A refusal counts one ``rejected_overcommit``
        (capacity) and additionally one ``holds`` when the policy declined
        requests that *do* fit (the deadline policy draining capacity to a
        starved window).  ``blocked_rid`` names the policy's most urgent
        non-fitting request; SLA-aware policies consume it to age starved
        requests (see :class:`~repro_torch.serving.admission.policies.
        DeadlinePolicy`).
        """
        if not queue:
            return None
        if self.observe_queue_depth is not None:
            self.observe_queue_depth(len(queue))
        fits = self.fits
        idx = self.policy.select(queue, fits, tuple(self._freed_streams))
        if idx is None:
            # a hold (hold-capable policy refusing while something still
            # fits — capacity deliberately drained for a starved window)
            # is NOT a capacity refusal; keep the counters disjoint so
            # rejected_overcommit retains its documented meaning.  A round
            # where the only refusals are tenant caps (the window fits the
            # ledger) is a quota rejection, not an over-commit.
            if (getattr(self.policy, "can_hold", False)
                    and any(fits(r) for r in queue)):
                self.stats.holds += 1
            elif self.quota is not None and any(
                    self.ledger.fits(self.admit_blocks(r))
                    and not self.quota.allows(r.stream,
                                              self.window_blocks(r))
                    for r in queue):
                self.quota.note_rejection()
            else:
                self.stats.rejected_overcommit += 1
            self._publish_decision("reject", None, queue, fits)
            return None
        # Affinity accounting: a hit means the admission exploited the
        # best *achievable* recycling affinity — the freshest freed stream
        # with any queued request.  (Matching nothing achievable counts
        # neither way; FCFS only hits when arrival order happens to align.)
        achievable = next(
            (s for s in self._freed_streams
             if any(q.stream == s for q in queue)), None)
        if achievable is not None:
            if queue[idx].stream == achievable:
                self.stats.affinity_hits += 1
            else:
                self.stats.affinity_misses += 1
        self._publish_decision("admit", queue[idx], queue, fits)
        return idx

    def _publish_decision(self, decision: str, request,
                          queue: list, fits) -> None:
        if not self.bus.wants(AdmissionDecision):
            return
        # blocked_rid is only computed when someone is listening — the
        # full-queue fits() scan stays off the unobserved hot path
        self.bus.publish(AdmissionDecision(
            decision=decision,
            rid=None if request is None else request.rid,
            policy=self.policy.name,
            queue_depth=len(queue),
            window_blocks=(None if request is None
                           else self.window_blocks(request)),
            blocked_rid=self.policy.most_urgent_blocked(
                queue, self._starvable_fits),
            tenant=None if request is None else request.stream))

    def on_admit(self, r, worker: int = 0) -> None:
        """Commit the admitted request's reservation (raises on
        over-commit) — the full window monolithically, the first chunk
        plus tail under chunked admission (see :meth:`admit_blocks`)."""
        self.ledger.reserve(r.rid, self.admit_blocks(r), worker)
        self._admit_order[r.rid] = next(self._admit_seq)
        self.stats.admitted += 1

    def on_allocated(self, r, unique_blocks: int) -> None:
        """Reconcile ``r``'s reservation with the allocation that actually
        happened: admission reserved a probe-based *estimate* of the
        unique footprint; the mapping now knows the truth
        (``num_blocks - prefix_hits``).  Growth is refused loudly
        (:class:`CapacityError`) like any reservation — the engine frees
        the mapping and retries under pressure relief."""
        if not self.ledger.holds(r.rid):
            return
        unique = max(1, int(unique_blocks))
        held = self.ledger.entries[r.rid].blocks
        if unique > held:
            self.ledger.grow(r.rid, unique - held)
        elif unique < held:
            self.ledger.shrink(r.rid, held - unique)

    def on_extend(self, r, n_blocks: int) -> None:
        """A running sequence grew its mapping beyond the admitted
        reservation (a prefill chunk, a COW divergence, a decode crossing
        a block boundary): grow the reservation or refuse loudly."""
        self.ledger.grow(r.rid, n_blocks)
        self.stats.chunk_grows += 1

    def defer_growth(self, r, n_blocks: int, queue: list) -> bool:
        """Should ``r``'s next chunk growth yield this step?

        Consults the policy's optional ``defer_growth(r, n, queue, fits)``
        hook — how a policy ranks a partially-prefilled grower against
        queued mice (or an imminent reshard; see
        :meth:`note_reshard_distance`).  Policies without the hook never
        defer.  Deferral is advisory and must be bounded by the policy —
        a grower always eventually proceeds.
        """
        hook = getattr(self.policy, "defer_growth", None)
        if hook is None:
            return False
        return bool(hook(r, n_blocks, queue, self.fits))

    def note_reshard_distance(self, steps: "int | None") -> None:
        """Expose the distance (engine/sim steps) to the next planned
        topology change; reshard-aware policies read it in ``select`` and
        ``defer_growth`` (``None`` = no reshard scheduled)."""
        self.policy.reshard_distance = steps

    def on_release(self, r) -> None:
        """Completion or preemption: return the window, remember the stream."""
        if self.ledger.holds(r.rid):
            self.ledger.release(r.rid)
        if self.quota is not None:
            self.quota.release(r.rid)
        self._admit_order.pop(r.rid, None)
        self.note_freed_stream(r.stream)

    def note_freed_stream(self, stream: str) -> None:
        """Newest-first affinity hint (dedup keeps the deque informative)."""
        if stream in self._freed_streams:
            self._freed_streams.remove(stream)
        self._freed_streams.appendleft(stream)

    # ---------------------------------------------------------- preemption
    def choose_victim(self, running: dict, *,
                      below_priority: int | None = None,
                      exclude: tuple = ()) -> Optional[object]:
        """Lowest priority class, then most recently admitted (vLLM LIFO).

        ``below_priority`` restricts victims to strictly lower classes
        (priority-pressure preemption must never evict an equal or higher
        class); ``exclude`` protects requests already being served this
        scan (e.g. the fault that triggered the pressure).
        """
        candidates = [
            r for r in running.values()
            if r.rid not in exclude
            and (below_priority is None
                 or getattr(r, "priority", 0) < below_priority)]
        if not candidates:
            return None
        return max(candidates,
                   key=lambda r: (-getattr(r, "priority", 0),
                                  self._admit_order.get(r.rid, 0)))

    def count_preempt(self, strategy: str) -> None:
        if strategy == "swap":
            self.stats.preemptions_swap += 1
        else:
            self.stats.preemptions_recompute += 1

    def wants_priority_preempt(self, queue: list) -> Optional[int]:
        """Index of a blocked queued request whose class justifies evicting
        a lower-class running sequence (priority policy only)."""
        if not isinstance(self.policy, PriorityPolicy) or not queue:
            return None
        return self.policy.best_blocked(queue, self._starvable_fits)

    # ------------------------------------------------------------ counters
    def counters(self) -> dict:
        d = self.stats.snapshot()
        d["policy"] = self.policy.name
        d["preempt_strategy"] = self.config.preempt
        d["ledger"] = self.ledger.counters()
        if self.topology is not None:
            t = self.topology
            per_worker = d["ledger"]["per_worker_committed"]
            d["ledger"]["per_island_committed"] = [
                sum(per_worker[w] for w in t.workers_in(i)
                    if w < len(per_worker))
                for i in range(t.num_islands)]
        d["quota"] = (self.quota.counters() if self.quota is not None
                      else {"enabled": False, "tenants": 0, "rejections": 0})
        return d


__all__ = ["CapacityError", "GovernorConfig", "GovernorStats",
           "MemoryGovernor", "PREEMPT_STRATEGIES"]
