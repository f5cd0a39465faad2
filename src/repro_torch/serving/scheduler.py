"""Continuous-batching scheduler with FPR-aware block lifecycle.

Requests flow  queued → prefill → decoding → done.  Completion frees the
sequence's blocks (the munmap analogue — with FPR the fence is skipped and
the blocks recycle to the next admitted request of the same stream), and
admission allocates them back (the allocation-phase check).

**Admission is the allocation phase.**  The paper moves the shootdown
check from release to allocation (§IV-A); in the serving stack the
matching boundary is admission: which queued request inherits the freed
blocks decides whether the allocation-phase check finds its *own*
context's blocks (a fence-free ``recycled_hit``) or a foreign context's (a
context-exit fence).  The scheduler itself stays mechanism-only — it
moves requests between queue and slots; *policy* (capacity checks,
admission order, victim choice) lives in
:mod:`repro_torch.serving.admission` and is driven by the engine.  Legacy
``admit()`` (no governor) fills every free slot regardless of pool
capacity, which is what over-commits the pool on tight configurations.

**Preemption is the kswapd analogue.**  Under memory pressure a victim
loses its slot and re-queues at the front.  :meth:`preempt` either frees
the victim's mapping (recompute strategy: blocks recycle fence-free under
FPR, the sequence re-prefills on re-admission) or keeps mapping and
generated tokens intact (swap strategy: the caller has already pushed the
blocks out through the watermark evictor, and the demand pager faults
them back in after re-admission).  Either way the victim's blocks leave
the running set — a preempted mapping is never silently leaked.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.block_table import Mapping


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    stream: str = "default"
    group_id: int = 1
    priority: int = 0                  # admission class (higher = sooner)
    arrival: int = 0                   # submission ordinal (deterministic
                                       # virtual arrival time)
    sla: Optional[float] = None        # deadline budget for SLA-aware
                                       # admission (deadline = arrival+sla)
    prefix_hashes: tuple = ()          # chain hashes of the prompt's full
                                       # blocks (computed once at submit;
                                       # admission probes + alloc reuse it)
    # runtime
    slot: Optional[int] = None
    mapping: Optional[Mapping] = None
    generated: list = field(default_factory=list)
    state: str = "queued"              # queued|prefill|running|done
    preemptions: int = 0
    prefill_pos: int = 0               # prompt tokens already prefilled
                                       # (chunked prefill state machine)
    submit_step: int = 0               # engine step at (re-)enqueue — the
                                       # queue-wait histogram's clock zero
                                       # (reset on preemption re-queue)

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.generated)


class Scheduler:
    """Slot-based continuous batching over a fixed decode batch."""

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.queue: list[Request] = []
        self.running: dict[int, Request] = {}      # slot → request
        self.done: list[Request] = []
        self._rid = itertools.count(1)

    def submit(self, prompt, max_new_tokens: int, stream: str = "default",
               group_id: int = 1, priority: int = 0,
               sla: Optional[float] = None,
               prefix_hashes: tuple = ()) -> int:
        rid = next(self._rid)
        self.queue.append(Request(rid=rid,
                                  prompt=np.asarray(prompt, np.int32),
                                  max_new_tokens=max_new_tokens,
                                  stream=stream, group_id=group_id,
                                  priority=priority, arrival=rid,
                                  sla=sla, prefix_hashes=prefix_hashes))
        return rid

    def admissible(self) -> list[int]:
        return [s for s in range(self.max_batch) if s not in self.running]

    def place(self, r: Request, slot: int, state: str = "running") -> None:
        """Seat an already-dequeued request in a free slot.

        ``state="prefill"`` seats a chunked-prefill request: it occupies a
        slot and its mapping participates in eviction/paging, but decode
        skips it until the engine promotes it to ``"running"`` once every
        prompt chunk is in the cache.
        """
        if slot in self.running:
            raise ValueError(f"slot {slot} already occupied")
        if state not in ("running", "prefill"):
            raise ValueError(f"cannot place a request in state {state!r}")
        r.slot = slot
        r.state = state
        self.running[slot] = r

    def admit(self) -> list[Request]:
        """Legacy admission: fill every free slot in arrival order
        (no capacity check — the governor path replaces this)."""
        admitted = []
        for slot in self.admissible():
            if not self.queue:
                break
            r = self.queue.pop(0)
            self.place(r, slot)
            admitted.append(r)
        return admitted

    def complete(self, r: Request) -> None:
        r.state = "done"
        del self.running[r.slot]
        self.done.append(r)

    def preempt(self, r: Request, *,
                free: Callable[[Mapping], None] | None = None,
                keep_mapping: bool = False) -> None:
        """Victim loses its slot and re-queues at the front.

        ``free`` releases the victim's blocks back to the cache (recompute
        strategy); the mapping is cleared *before* re-queueing so a
        preempted request can never leak blocks.  ``keep_mapping`` is the
        swap strategy: the caller has already swapped the blocks out, so
        mapping and generated tokens survive for fault-back re-admission.
        """
        if not keep_mapping and r.mapping is not None and free is None:
            raise ValueError(
                "preempting a mapped request without a free callback "
                "would leak its blocks; pass free= or keep_mapping=True")
        del self.running[r.slot]
        r.slot = None
        r.state = "queued"
        r.preemptions += 1
        if not keep_mapping:
            if r.mapping is not None:
                free(r.mapping)
                r.mapping = None
            r.generated.clear()        # re-prefill on re-admission
            r.prefill_pos = 0          # chunked prefill restarts from 0
        self.queue.insert(0, r)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running
