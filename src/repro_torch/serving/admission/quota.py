"""Per-tenant admission quotas — an ``AdmissionDecision`` subscriber.

Multi-tenant serving needs more than a global capacity ledger: one tenant
flooding the queue can commit the whole pool and starve everyone else even
though every single admission was capacity-sound.  :class:`TenantQuota` is
a small ledger wrapper that caps the *committed window blocks per tenant*
(tenant = the request's ``stream`` — the same key FPR recycling contexts
derive from, so a tenant's quota bounds exactly the block population its
recycling context can cycle).

Wiring follows the control-plane pattern: the quota *observes* the
governor's :class:`~repro_torch.core.events.AdmissionDecision` stream to charge
admitted windows (it subscribes on the shared bus; the ``tenant`` field on
the event is its key), and the governor consults :meth:`allows` inside its
capacity predicate so a tenant at its cap is simply never selected —
rejection is a refusal-to-admit, never an exception on the engine path.
Releases (completion / preemption) flow through
:meth:`~repro_torch.serving.admission.governor.MemoryGovernor.on_release`, which
credits the quota back.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.events import AdmissionDecision, EventBus


class TenantQuota:
    """Committed-block caps per tenant, charged from admission events.

    ``caps`` maps tenant name → max committed window blocks;
    ``default_cap`` applies to tenants not listed (``None`` = unlimited).
    """

    def __init__(self, caps: dict, *, default_cap: Optional[int] = None,
                 bus: Optional[EventBus] = None):
        for tenant, cap in caps.items():
            if cap is not None and cap <= 0:
                raise ValueError(
                    f"tenant {tenant!r} cap must be positive, got {cap}")
        if default_cap is not None and default_cap <= 0:
            raise ValueError(f"default_cap must be positive, "
                             f"got {default_cap}")
        self.caps = dict(caps)
        self.default_cap = default_cap
        self.committed: dict[str, int] = {}
        self._held: dict[int, tuple[str, int]] = {}   # rid → (tenant, blocks)
        self.rejections = 0           # admission rounds refused by a cap
        if bus is not None:
            bus.subscribe(AdmissionDecision, self.on_decision)

    # ------------------------------------------------------------- predicate
    def cap_of(self, tenant: str) -> Optional[int]:
        return self.caps.get(tenant, self.default_cap)

    def allows(self, tenant: str, blocks: int) -> bool:
        """Would admitting ``blocks`` keep ``tenant`` within its cap?"""
        cap = self.cap_of(tenant)
        return cap is None or self.committed.get(tenant, 0) + blocks <= cap

    # ------------------------------------------------------- event consumption
    def on_decision(self, evt: AdmissionDecision) -> None:
        """Charge every ``"admit"`` decision against its tenant's cap."""
        if (evt.decision != "admit" or evt.rid is None
                or evt.tenant is None or not evt.window_blocks):
            return
        if evt.rid in self._held:      # re-published round: never double-charge
            return
        self._held[evt.rid] = (evt.tenant, evt.window_blocks)
        self.committed[evt.tenant] = (self.committed.get(evt.tenant, 0)
                                      + evt.window_blocks)

    def release(self, rid: int) -> None:
        """Credit a completed/preempted request's window back (no-op for
        rids the quota never charged)."""
        held = self._held.pop(rid, None)
        if held is None:
            return
        tenant, blocks = held
        left = self.committed.get(tenant, 0) - blocks
        if left > 0:
            self.committed[tenant] = left
        else:
            self.committed.pop(tenant, None)

    def note_rejection(self) -> None:
        self.rejections += 1

    # --------------------------------------------------------------- counters
    def counters(self) -> dict:
        return {"enabled": True,
                "tenants": len(self.committed),
                "rejections": self.rejections}


__all__ = ["TenantQuota"]
