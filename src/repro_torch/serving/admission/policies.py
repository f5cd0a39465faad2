"""Pluggable admission policies — who gets the freed blocks next.

The paper's FPR only pays off when a freed mapping's blocks recycle into
the *same* recycling context's next mmap; in the serving analogue the
admission order decides that.  Each policy picks the next queued request
to admit, given a capacity predicate (from the :class:`~repro_torch.serving.
admission.ledger.CapacityLedger`) and an affinity hint (the most recently
freed streams):

  * ``fcfs``     — arrival order, skipping requests that do not currently
                   fit (first-fit FCFS; strict head-of-line blocking would
                   deadlock behind a window larger than what is free).
  * ``recycle``  — recycle-affinity: prefer the queued request whose
                   ``stream`` matches the most recently freed mapping's
                   stream, so the freed blocks re-enter the same recycling
                   context and the context-exit fence is averted entirely
                   (allocation finds its own context's blocks: a
                   ``recycled_hit``, no fence, no device-table refresh).
  * ``priority`` — highest priority class first (ties broken FCFS); the
                   governor may additionally preempt lower-priority
                   running sequences to make room (see ``MemoryGovernor``).
  * ``deadline`` — earliest-deadline-first (arrival + SLA budget) over the
                   requests that fit, **consuming**
                   :class:`~repro_torch.core.events.AdmissionDecision` events to
                   detect starvation: once the most urgent request has been
                   passed over ``hold_after`` times because its window does
                   not fit, the policy *holds* — admits nothing — so
                   capacity drains to it instead of being nibbled away by
                   smaller late arrivals (the first-fit starvation that
                   inflates FCFS p99 queue-wait).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

#: fits(request) → can the ledger hold this request's window right now?
FitsFn = Callable[[object], bool]


class AdmissionPolicy:
    """Selects the index of the next queue entry to admit (None = nothing)."""

    name = "abstract"
    #: True for policies whose select() may refuse while a queued request
    #: still fits (capacity holds) — the governor counts those rounds as
    #: ``admission.holds``.  Orthogonal to event consumption (attach()).
    can_hold = False
    #: steps until the next planned topology change (None = none scheduled)
    #: — set by the governor (``note_reshard_distance``); reshard-aware
    #: policies read it to defer elephant chunk-growth across the boundary.
    reshard_distance: "int | None" = None

    def select(self, queue: Sequence, fits: FitsFn,
               freed_streams: Sequence[str]) -> Optional[int]:
        raise NotImplementedError

    def most_urgent_blocked(self, queue: Sequence,
                            fits: FitsFn) -> Optional[int]:
        """``rid`` of the request this policy most wants but cannot seat —
        published in :class:`AdmissionDecision` events so SLA-aware
        policies (and dashboards) can observe starvation.  Default: the
        first queued request (arrival order) that does not fit."""
        for r in queue:
            if not fits(r):
                return r.rid
        return None


class FcfsPolicy(AdmissionPolicy):
    """First-come-first-served over the requests that currently fit."""

    name = "fcfs"

    def select(self, queue, fits, freed_streams):
        for i, r in enumerate(queue):
            if fits(r):
                return i
        return None


class RecycleAffinityPolicy(AdmissionPolicy):
    """Prefer the queued request whose stream matches the freshest free.

    Walks the recently-freed streams newest-first; the first queued request
    (in arrival order) of a matching stream that fits wins.  Falls back to
    FCFS when no queued request matches any recently freed stream — the
    affinity is a preference, never a starvation mechanism.
    """

    name = "recycle"

    def select(self, queue, fits, freed_streams):
        for stream in freed_streams:
            for i, r in enumerate(queue):
                if r.stream == stream and fits(r):
                    return i
        return FcfsPolicy.select(self, queue, fits, freed_streams)


class PriorityPolicy(AdmissionPolicy):
    """Highest ``priority`` class first; FCFS within a class."""

    name = "priority"

    def select(self, queue, fits, freed_streams):
        best = None
        for i, r in enumerate(queue):
            if not fits(r):
                continue
            if best is None or getattr(r, "priority", 0) > getattr(
                    queue[best], "priority", 0):
                best = i
        return best

    def best_blocked(self, queue, fits) -> Optional[int]:
        """Highest-priority queued request that does NOT currently fit —
        the preemption candidate's beneficiary (vLLM-style pressure)."""
        best = None
        for i, r in enumerate(queue):
            if fits(r):
                continue
            if best is None or getattr(r, "priority", 0) > getattr(
                    queue[best], "priority", 0):
                best = i
        return best


class DeadlinePolicy(AdmissionPolicy):
    """Earliest-deadline-first admission with starvation holds (SLA-aware).

    A request's deadline is ``arrival + sla`` (``sla`` defaults to
    ``default_sla`` when the request carries none; ``arrival`` falls back
    to the submission-ordered ``rid``).  Selection is EDF over the
    requests that currently fit.

    **Event-driven holds.**  The policy subscribes to
    :class:`~repro_torch.core.events.AdmissionDecision` (via :meth:`attach`,
    called by the governor): every ``"admit"`` decision whose
    ``blocked_rid`` names the policy's most urgent request counts one
    *leapfrog* — a later arrival seated past it because its window did not
    fit.  Once a request has been leapfrogged ``hold_after`` times,
    ``select`` admits *nothing* until that request fits — running work
    drains, the freed window accumulates, and the starved request is
    seated with bounded delay instead of watching smaller late arrivals
    nibble freed capacity forever (FCFS first-fit's tail pathology on
    mice-and-elephants workloads).
    """

    name = "deadline"
    can_hold = True

    def __init__(self, default_sla: float = 64.0, hold_after: int = 8,
                 reshard_horizon: int = 1):
        if hold_after < 1:
            raise ValueError(f"hold_after must be >= 1, got {hold_after}")
        if reshard_horizon < 0:
            raise ValueError(f"reshard_horizon must be >= 0, "
                             f"got {reshard_horizon}")
        self.default_sla = default_sla
        self.hold_after = hold_after
        self.reshard_horizon = reshard_horizon
        self._deferrals: dict[int, int] = {}        # rid → true leapfrogs
        self._grow_deferrals: dict[int, int] = {}   # rid → growth deferrals
        self._last_deadlines: dict[int, tuple] = {}  # rid → deadline @select
        #: (queue rid tuple, EDF index order, rid → deadline) memo
        self._order_cache: "tuple[tuple, list, dict] | None" = None
        #: set by the governor: "would freeing capacity help this
        #: request?" — True for a request blocked only by a tenant quota,
        #: which a hold can never seat (see MemoryGovernor._starvable_fits)
        self.starvation_fits: "FitsFn | None" = None

    def deadline(self, r) -> tuple:
        arrival = getattr(r, "arrival", None)
        if arrival is None:
            arrival = r.rid
        sla = getattr(r, "sla", None)
        if sla is None:
            sla = self.default_sla
        return (arrival + sla, arrival)             # ties: earlier arrival

    def _edf_order(self, queue) -> list[int]:
        """EDF index order, memoised per queue composition — the governor
        re-asks for it (``most_urgent_blocked``) in the same round that
        ``select`` already sorted.  The per-rid deadline map rides in the
        cache too (``_order_cache[2]``) so select() never recomputes it."""
        key = tuple(r.rid for r in queue)
        if self._order_cache is not None and self._order_cache[0] == key:
            return self._order_cache[1]
        deadlines = {r.rid: self.deadline(r) for r in queue}
        order = sorted(range(len(queue)),
                       key=lambda i: deadlines[queue[i].rid])
        self._order_cache = (key, order, deadlines)
        return order

    def select(self, queue, fits, freed_streams):
        order = self._edf_order(queue)
        if not order:
            return None
        # remember each request's deadline so on_decision can classify the
        # admission it triggers as a true leapfrog or an EDF-correct pick
        self._last_deadlines = self._order_cache[2]
        urgent = queue[order[0]]
        if fits(urgent):
            return order[0]
        if self._deferrals.get(urgent.rid, 0) >= self.hold_after:
            # hold — drain capacity to the starver — but only while the
            # starver is CAPACITY-blocked: a quota-blocked urgent request
            # cannot be seated by freed capacity, so holding for it would
            # waste the pool on a request the hold can never help
            sf = self.starvation_fits
            if sf is None or not sf(urgent):
                return None
        for i in order[1:]:
            if fits(queue[i]):
                return i
        return None

    def most_urgent_blocked(self, queue, fits):
        order = self._edf_order(queue)
        for i in order:
            if not fits(queue[i]):
                return queue[i].rid
        return None

    def defer_growth(self, r, n_blocks, queue, fits):
        """Rank a partially-prefilled grower against queued mice and the
        topology schedule: defer ``r``'s chunk growth this step when a
        strictly more urgent queued request currently fits (the freed
        headroom seats the mouse first), or when a reshard lands within
        ``reshard_horizon`` steps (an elephant's growth is the largest
        single per-worker commitment a reshard would have to remap —
        landing it after the boundary keeps the move set minimal).
        Deferral is bounded per request (``hold_after``) so a grower
        always eventually proceeds — no livelock behind a persistent
        mouse stream.
        """
        seen = self._grow_deferrals.get(r.rid, 0)
        if seen >= self.hold_after:
            self._grow_deferrals.pop(r.rid, None)
            return False
        mine = self.deadline(r)
        urgent_fits = any(self.deadline(q) < mine and fits(q)
                          for q in queue)
        near_reshard = (self.reshard_distance is not None
                        and self.reshard_distance <= self.reshard_horizon)
        if urgent_fits or near_reshard:
            self._grow_deferrals[r.rid] = seen + 1
            return True
        self._grow_deferrals.pop(r.rid, None)
        return False

    # ------------------------------------------------------ event consumption
    def attach(self, bus) -> None:
        """Subscribe to the governor's ``AdmissionDecision`` stream."""
        from repro_torch.core.events import AdmissionDecision
        bus.subscribe(AdmissionDecision, self.on_decision)

    def on_decision(self, evt) -> None:
        if evt.decision != "admit":
            return
        if evt.blocked_rid is not None and evt.rid != evt.blocked_rid:
            # a TRUE leapfrog only: the admitted request's deadline is
            # later than the blocked one's — the first-fit bypass that
            # starves large windows.  An EDF-correct admission of a
            # more-urgent request must not age the blocked one toward a
            # hold (capacity it never contended for).
            admitted = self._last_deadlines.get(evt.rid)
            blocked = self._last_deadlines.get(evt.blocked_rid)
            if admitted is not None and blocked is not None \
                    and admitted > blocked:
                self._deferrals[evt.blocked_rid] = (
                    self._deferrals.get(evt.blocked_rid, 0) + 1)
        if evt.rid is not None:
            self._deferrals.pop(evt.rid, None)


_POLICIES = {p.name: p for p in (FcfsPolicy, RecycleAffinityPolicy,
                                 PriorityPolicy, DeadlinePolicy)}


def make_policy(policy: "str | AdmissionPolicy") -> AdmissionPolicy:
    if isinstance(policy, AdmissionPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown admission policy {policy!r}; "
                         f"known: {sorted(_POLICIES)}") from None
