"""Recycling-context derivation — the paper's §IV-C2 "extended recycling contexts".

The paper defines four context scopes for the 22-bit tracking id:

  1. per-mmap    : ``(pid << mmap_bits) + mmap_id``   (eviction-only recycling)
  2. per-process : ``pid``                            (the default)
  3. per-parent  : ``parent_pid``                     (shared child mappings)
  4. per-uid     : ``uid``                            (all processes of a user)

In the serving framework the analogous scopes are:

  1. PER_MAPPING : one context per individual KV mapping (a single request's
                   block-table) — recycling only happens through eviction,
                   since back-to-back requests get fresh mappings.
  2. PER_GROUP   : one context per request group / engine stream (≈ process).
                   The default: sequences of the same stream recycle blocks.
  3. PER_PARENT  : one context per parent stream, shared by all child streams
                   (≈ fork-children sharing).
  4. PER_TENANT  : one context per tenant (≈ uid) — every stream of a tenant
                   shares one recycling pool.  Widest scope, requires the
                   tenant to trust its streams (paper's trust caveat).

Context ids must be non-zero (0 == non-FPR) and fit in 22 bits.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from repro_torch.core.tracking import MAX_CONTEXT_ID

_MAP_BITS = 8  # low bits reserved for the per-mapping sub-id in PER_MAPPING


class ContextScope(enum.Enum):
    PER_MAPPING = "per_mapping"
    PER_GROUP = "per_group"      # paper's default: tracking_id = pid
    PER_PARENT = "per_parent"    # tracking_id = parent_pid
    PER_TENANT = "per_tenant"    # tracking_id = uid


@dataclass(frozen=True)
class RecyclingContext:
    """A resolved recycling context: the non-zero 22-bit tracking id."""

    ctx_id: int
    scope: ContextScope

    def __post_init__(self):
        if not (1 <= self.ctx_id <= MAX_CONTEXT_ID):
            raise ValueError(
                f"recycling ctx_id must be in [1, {MAX_CONTEXT_ID}], got {self.ctx_id}")


#: Sentinel "context" for standard, non-FPR allocations (tracking id 0).
NON_FPR_ID = 0


def derive_context(scope: ContextScope, *, group_id: int, mapping_id: int = 0,
                   parent_id: int | None = None,
                   tenant_id: int | None = None) -> RecyclingContext:
    """Derive the tracking id exactly as §IV-C2 specifies."""
    if scope is ContextScope.PER_MAPPING:
        cid = ((group_id << _MAP_BITS) + (mapping_id & ((1 << _MAP_BITS) - 1)))
    elif scope is ContextScope.PER_GROUP:
        cid = group_id
    elif scope is ContextScope.PER_PARENT:
        if parent_id is None:
            raise ValueError("PER_PARENT scope requires parent_id")
        cid = parent_id
    elif scope is ContextScope.PER_TENANT:
        if tenant_id is None:
            raise ValueError("PER_TENANT scope requires tenant_id")
        cid = tenant_id
    else:  # pragma: no cover
        raise ValueError(scope)
    # Keep ids in range and non-zero.  Real kernels would allocate pids within
    # 22 bits; we wrap deterministically (collisions only widen contexts,
    # which is safe: a wider context only *delays* fences it is entitled to).
    cid = (cid % MAX_CONTEXT_ID) + 1 if cid % MAX_CONTEXT_ID == 0 else cid % MAX_CONTEXT_ID
    return RecyclingContext(ctx_id=cid, scope=scope)


class ContextRegistry:
    """Allocates unique group/tenant ids and resolves contexts for streams.

    This is the engine-facing façade: a serving *stream* (≈ process) asks for
    its recycling context once and passes it to every alloc/free.  The
    ``intercept`` flag mirrors the paper's LD_PRELOAD interception library —
    when set for a stream pattern, *all* allocations of matching streams are
    FPR-flagged without the caller opting in.
    """

    def __init__(self, default_scope: ContextScope = ContextScope.PER_GROUP):
        self.default_scope = default_scope
        self._next_group = 1
        self._intercept_prefixes: list[str] = []

    def new_group_id(self) -> int:
        gid = self._next_group
        self._next_group += 1
        return gid

    # -- interception library analogue (§IV-C3) ------------------------------
    def add_intercept(self, stream_prefix: str) -> None:
        """FPR-flag every mapping of streams whose name matches the prefix,
        without the stream changing its own calls (LD_PRELOAD analogue)."""
        self._intercept_prefixes.append(stream_prefix)

    def intercepted(self, stream_name: str) -> bool:
        return any(stream_name.startswith(p) for p in self._intercept_prefixes)

    def resolve(self, *, group_id: int, stream_name: str = "",
                use_fpr: bool = False, scope: ContextScope | None = None,
                mapping_id: int = 0, parent_id: int | None = None,
                tenant_id: int | None = None) -> RecyclingContext | None:
        """Return the recycling context, or ``None`` for a standard mapping.

        ``None`` ⇒ tracking id 0 ⇒ the default shootdown path (fence at free).
        """
        if not use_fpr and not self.intercepted(stream_name):
            return None
        return derive_context(scope or self.default_scope, group_id=group_id,
                              mapping_id=mapping_id, parent_id=parent_id,
                              tenant_id=tenant_id)
