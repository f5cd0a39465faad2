"""Admission-control & preemption subsystem — the capacity-aware memory
governor between the scheduler and the paged KV cache.

See :mod:`repro_torch.serving.admission.governor` for the design overview:
the ledger makes "committed windows ≤ pool" an admission-time invariant
(closing the demand-pager give-up hole), the policies decide which queued
request inherits freed blocks (recycle-affinity keeps FPR recycling hot),
and the preemption strategies (recompute / swap-through-the-evictor) keep
over-committed configurations sound instead of shipping ``-1`` rows.
"""

from repro_torch.serving.admission.governor import (PREEMPT_STRATEGIES,
                                              GovernorConfig, GovernorStats,
                                              MemoryGovernor)
from repro_torch.serving.admission.ledger import CapacityError, CapacityLedger
from repro_torch.serving.admission.policies import (AdmissionPolicy,
                                              DeadlinePolicy, FcfsPolicy,
                                              PriorityPolicy,
                                              RecycleAffinityPolicy,
                                              make_policy)
from repro_torch.serving.admission.quota import TenantQuota

__all__ = [
    "AdmissionPolicy",
    "CapacityError",
    "CapacityLedger",
    "DeadlinePolicy",
    "FcfsPolicy",
    "GovernorConfig",
    "GovernorStats",
    "MemoryGovernor",
    "PREEMPT_STRATEGIES",
    "PriorityPolicy",
    "RecycleAffinityPolicy",
    "TenantQuota",
    "make_policy",
]
