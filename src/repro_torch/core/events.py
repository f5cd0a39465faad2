"""Typed coherence-event bus — the control plane's observation surface.

The paper's contribution is an *API extension*: mmap is taught to tell the
kernel "these pages will be recycled", and everything else (fence skipping,
allocation-phase checks, version elision) follows from that one clean
interface.  This module is the same move applied to the repro's own control
surface: instead of signature-sniffed ``on_fence`` wrapper chains and bare
attribute hooks, every cross-layer observation is a **frozen dataclass
event** published on an :class:`EventBus` with per-type subscription.

Publishers (mechanism layer):

  * :class:`~repro_torch.core.shootdown.FenceEngine` publishes
    :class:`FenceIssued` for every coherence fence (global or scoped).
  * :class:`~repro_torch.core.fpr.FprMemoryManager` publishes
    :class:`BlocksRecycled` / :class:`ContextExit` from the §IV-A
    allocation-phase checks, :class:`BlocksShared` / :class:`SharingExit`
    from the prefix-sharing attach/detach paths, and :class:`SwapDropped`
    when a dying mapping still holds swapped-out blocks.
  * :class:`~repro_torch.serving.kv_cache.PagedKVCache` publishes
    :class:`ShardRefreshed` after a fence re-uploads device table shards.
  * :class:`~repro_torch.serving.admission.MemoryGovernor` publishes
    :class:`AdmissionDecision`; the engine publishes
    :class:`PreemptionStarted` / :class:`PreemptionResolved`.

Subscribers (policy/observability layer): the manager's table-epoch bump,
the cache's device-shard refresh and swap-store cleanup, the governor's
preemption counters, and the SLA/deadline admission policy all plug in via
``bus.subscribe(EventType, handler)`` — new policies observe the stack
without touching the hot path.

Handlers run **synchronously, in subscription order** (exact-type handlers
first, then wildcard :class:`Event` handlers).  Publish order therefore
*is* the coherence order: the table-epoch bump is subscribed before the
device refresh, exactly like the old wrapper chain, but explicitly.

Hot-path publishers guard event construction with :meth:`EventBus.wants`
so an unobserved event costs one dict lookup, not an allocation.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Type


@dataclass(frozen=True)
class Event:
    """Base class for all control-plane events (also the wildcard topic)."""


# ------------------------------------------------------------------ coherence
@dataclass(frozen=True)
class FenceIssued(Event):
    """One coherence fence was performed (the TLB-shootdown analogue).

    ``workers`` is ``None`` for a global fence (every replica refreshed —
    the paper's broadcast pessimism) or the tuple of covered worker ids for
    a scoped one.  ``seq`` is the engine's total fence ordinal, ``epoch``
    the §IV-C5 global shootdown counter after this fence.
    """

    reason: str
    n_blocks: int
    workers: "tuple[int, ...] | None"
    seq: int
    epoch: int
    scoped: bool


@dataclass(frozen=True)
class BlocksRecycled(Event):
    """An allocation found its own context's blocks (fence-free recycling)."""

    ctx_id: int
    n_blocks: int
    worker: int


@dataclass(frozen=True)
class ContextExit(Event):
    """Blocks left a foreign recycling context at allocation (§IV-A).

    ``fenced`` says whether the exit required a fence this time;
    ``elided_by_version`` / ``elided_by_scope`` count the blocks whose
    deferred invalidation was already covered (§IV-C5 epoch / per-worker
    fence) and therefore exited fence-free.
    """

    ctx_id: int
    n_blocks: int
    fenced: bool
    elided_by_version: int
    elided_by_scope: int


@dataclass(frozen=True)
class BlocksShared(Event):
    """A new mapping attached to indexed prefix blocks (a prefix-cache hit).

    ``n_blocks`` is the number of shared blocks attached — blocks the
    allocation did **not** have to acquire (and will never fence for while
    they stay inside their sharing set)."""

    ctx_id: int
    n_blocks: int
    worker: int
    mapping_id: int


@dataclass(frozen=True)
class SharingExit(Event):
    """Blocks changed sharing-set membership at a detach point.

    ``n_blocks`` counts blocks whose *last* sharer detached — they left
    their set, were version-stamped, and rejoined the ordinary recycling
    machinery (the "page leaves its recycling cycle" moment; the next
    foreign allocation decides fence vs. elision).  ``orphaned`` is the
    subset of those whose owner had already died.  ``newly_orphaned``
    counts blocks that did *not* exit but whose owner detached just now —
    they stay live, held by the remaining sharers, and are what the
    admission ledger must keep covering as shared residual.  ``reason`` is
    ``"munmap"``, ``"cow"`` or ``"evict"``.
    """

    n_blocks: int
    orphaned: int
    newly_orphaned: int
    reason: str


@dataclass(frozen=True)
class SwapDropped(Event):
    """A mapping died while this block was swapped out — the swap-store
    copy must be released or it is orphaned forever (mapping ids never
    recycle)."""

    mapping_id: int
    logical_idx: int


@dataclass(frozen=True)
class ShardRefreshed(Event):
    """A fence re-uploaded device block-table shards (the measured
    rebroadcast).  ``full`` marks the global-fence fallback that refreshes
    every shard."""

    reason: str
    shards: "tuple[int, ...]"
    entries: int
    nbytes: int
    full: bool


@dataclass(frozen=True)
class TopologyChanged(Event):
    """The worker topology was resharded (elastic scale up/down).

    ``translation`` maps every old worker id to the new id that inherits
    its presence-mask bits and fence epoch.  ``moved_slots`` are the batch
    slots whose device-shard owner changed — the only rows a reshard has
    to re-broadcast (everything else keeps its device copy).
    ``fence_workers`` names the pre-existing workers whose epoch the
    accompanying scoped ``reason="reshard"`` fence bumps (empty tuple ⇒
    no live row moved and the reshard was fence-free).

    ``islands`` is the new topology's island spec (tuple of worker-id
    tuples) when the reshape installed a multi-island topology, ``None``
    for the flat degenerate case — a plain ``resize_workers`` publishes
    exactly the pre-island event.
    """

    old_num_workers: int
    new_num_workers: int
    translation: "tuple[int, ...]"       # old worker id → new worker id
    moved_slots: "tuple[int, ...]"
    fence_workers: "tuple[int, ...]"
    islands: "tuple | None" = None       # new island spec (None ⇒ flat)


@dataclass(frozen=True)
class EvictionPass(Event):
    """One watermark-daemon pass completed (the kswapd wakeup analogue).

    ``kind`` is ``"normal"`` (low..min band, stock batches of 32, FPR
    pages exempt) or ``"huge"`` (at/below min: one batch, one merged
    fence).  ``scanned`` counts victim candidates walked, ``dropped`` the
    blocks actually evicted (every drop is a swap-out through the swap
    path), ``deferred`` the FPR-exempt pages skipped this pass.
    """

    kind: str
    scanned: int
    dropped: int
    deferred: int
    free_before: int
    free_after: int


# ------------------------------------------------------------------ admission
@dataclass(frozen=True)
class AdmissionDecision(Event):
    """The governor decided one admission round.

    ``decision`` is ``"admit"`` (``rid`` was seated) or ``"reject"`` (the
    queue was non-empty but nothing was admitted — capacity refusal or a
    deadline hold).  ``blocked_rid`` names the policy's most urgent queued
    request that did *not* fit this round; the SLA/deadline policy consumes
    it to age starved requests into capacity holds.
    """

    decision: str
    rid: "int | None"
    policy: str
    queue_depth: int
    window_blocks: "int | None"
    blocked_rid: "int | None"
    tenant: "str | None" = None        # admitted request's tenant (quota key)


@dataclass(frozen=True)
class PreemptionStarted(Event):
    """The engine is about to evict a running victim (kswapd analogue)."""

    rid: int
    strategy: str                      # requested: recompute | swap


@dataclass(frozen=True)
class PreemptionResolved(Event):
    """Victim eviction completed; ``strategy`` is what actually ran (swap
    falls back to recompute for slot-state architectures / unmapped
    victims)."""

    rid: int
    strategy: str


# ----------------------------------------------------------------- lifecycle
@dataclass(frozen=True)
class PrefillChunkDone(Event):
    """One fixed-shape prefill chunk landed for ``rid`` (tokens
    ``[start, end)`` of the prompt are now in the cache).  The trace
    layer stitches these into child spans of the request's root span."""

    rid: int
    start: int
    end: int
    step: int


@dataclass(frozen=True)
class RequestCompleted(Event):
    """``rid`` finished decoding and released its mapping — the close of
    the request's root span (admission opened it)."""

    rid: int
    n_tokens: int
    step: int


@dataclass(frozen=True)
class StepCompleted(Event):
    """One ``Engine.step`` finished.  ``wall_s`` is the step's wall time
    (the span's duration — a tracer reconstructs the start as
    ``now - wall_s``), ``tokens`` the decode tokens it produced,
    ``running`` the occupied slots after the step."""

    step: int
    tokens: int
    wall_s: float
    running: int


#: every event type this module defines, for docs/tests
EVENT_TYPES = (FenceIssued, BlocksRecycled, ContextExit, BlocksShared,
               SharingExit, SwapDropped, ShardRefreshed, TopologyChanged,
               EvictionPass, AdmissionDecision, PreemptionStarted,
               PreemptionResolved, PrefillChunkDone, RequestCompleted,
               StepCompleted)


Handler = Callable[[Event], None]


class EventBus:
    """Synchronous, typed publish/subscribe for control-plane events.

    One bus per engine stack (the cache, fence engine, memory manager and
    governor all share it).  Handlers for the exact event type run first in
    subscription order, then handlers subscribed to the :class:`Event`
    wildcard.  There is no queueing: ``publish`` returns after the last
    handler, so mechanism-critical subscribers (epoch bumps, device
    refreshes) see events in coherence order.

    **Error isolation.**  A raising subscriber must never take the
    publisher (or the subscribers behind it) down: the exception is
    caught, counted in :attr:`subscriber_errors` (exported as
    ``engine.obs.subscriber_errors``), remembered in :attr:`last_errors`,
    and delivery continues with the next ordered handler — the
    epoch-bump-before-device-refresh ordering survives a broken
    observability plug-in.
    """

    #: diagnostic ring size for :attr:`last_errors`
    ERROR_RING = 16

    def __init__(self) -> None:
        self._handlers: dict[Type[Event], list[Handler]] = {}
        #: deliveries dropped because the subscriber raised
        self.subscriber_errors = 0
        #: ``(event type name, handler repr, exception repr)`` ring of the
        #: most recent isolated failures
        self.last_errors: deque = deque(maxlen=self.ERROR_RING)

    # ---------------------------------------------------------- subscription
    def subscribe(self, event_type: Type[Event], handler: Handler,
                  *, first: bool = False) -> Callable[[], None]:
        """Register ``handler`` for ``event_type``; returns an unsubscribe
        callable.  Subscribe to :class:`Event` itself for every event.

        ``first=True`` prepends instead of appending — for
        mechanism-critical handlers that must observe the event before any
        earlier subscriber (the manager's table-epoch bump must precede
        even a legacy callback attached at fence-engine construction).
        """
        if not (isinstance(event_type, type)
                and issubclass(event_type, Event)):
            raise TypeError(f"not an Event type: {event_type!r}")
        handlers = self._handlers.setdefault(event_type, [])
        if first:
            handlers.insert(0, handler)
        else:
            handlers.append(handler)

        def unsubscribe() -> None:
            self.unsubscribe(event_type, handler)

        return unsubscribe

    def unsubscribe(self, event_type: Type[Event], handler: Handler) -> None:
        handlers = self._handlers.get(event_type, [])
        if handler in handlers:
            handlers.remove(handler)

    def wants(self, event_type: Type[Event]) -> bool:
        """Cheap hot-path guard: is anyone listening for this type?"""
        return bool(self._handlers.get(event_type)
                    or self._handlers.get(Event))

    # --------------------------------------------------------------- publish
    def _deliver(self, handler: Handler, event: Event) -> int:
        try:
            handler(event)
            return 1
        except Exception as exc:  # noqa: BLE001 — isolate, count, continue
            self.subscriber_errors += 1
            self.last_errors.append((type(event).__name__, repr(handler),
                                     repr(exc)))
            return 0

    def publish(self, event: Event) -> int:
        """Dispatch ``event``; returns the number of handlers that ran
        without raising (a raising handler is isolated and counted — see
        :attr:`subscriber_errors` — and delivery continues in order)."""
        ran = 0
        for handler in tuple(self._handlers.get(type(event), ())):
            ran += self._deliver(handler, event)
        if type(event) is not Event:
            for handler in tuple(self._handlers.get(Event, ())):
                ran += self._deliver(handler, event)
        return ran


__all__ = ["Event", "EventBus", "EVENT_TYPES", "FenceIssued",
           "BlocksRecycled", "ContextExit", "BlocksShared", "SharingExit",
           "SwapDropped", "ShardRefreshed", "TopologyChanged",
           "EvictionPass", "AdmissionDecision", "PreemptionStarted",
           "PreemptionResolved", "PrefillChunkDone", "RequestCompleted",
           "StepCompleted"]
