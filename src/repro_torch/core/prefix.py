"""Prefix index — sharing sets over token-block hashes (the recycling-cycle
analogue for *shared* pages).

The paper's core move is to skip the TLB shootdown while a physical page
stays inside its recycling cycle and fence only when the page exits the
cycle to a different owner.  Prefix sharing is the same discipline applied
to pages with *several* simultaneous owners: KV blocks holding a common
prompt prefix (system prompts, few-shot headers, multi-turn history) are
entered into a **sharing set** and mapped by every request with that
prefix.  While the set is non-empty the block is pinned — it never reaches
the allocator, so no stale translation can exist and **zero fences** are
needed, structurally.  Only when the last sharer detaches does the block
*exit* its set and rejoin the ordinary recycling machinery, where the
existing allocation-phase checks (`fpr._allocation_checks`) decide between
a scoped cross-tenant fence and a legitimate elision.

**Index shape.**  Chain hashes over *full* token blocks::

    h_0 = H(seed,  tokens[0:bs])
    h_i = H(h_i-1, tokens[i*bs:(i+1)*bs])

The chain hash encodes the whole prefix, so the hash sequence *is* the trie
path and a flat ``hash -> entry`` dict gives trie-style longest-prefix
matching: walk the request's hash chain from the root and stop at the first
miss.  Partial (tail) blocks are never indexed — the decode loop writes
into them.

**Trust note.**  The index is global (cross-stream): any request whose
token prefix hashes to an indexed chain attaches to the shared blocks.
That is the standard serving trade (identical tokens ⇒ identical KV), but
it means tenants in one pool can observe latency differences from each
other's prompts; a per-tenant index seed would partition the sets if that
ever matters.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

__all__ = ["block_hashes", "PrefixIndex", "PrefixEntry", "PrefixStats"]

_SEED = b"repro-prefix-v1"


def block_hashes(tokens, block_size: int) -> tuple:
    """Chain hashes of the *full* token blocks of ``tokens``.

    Deterministic across processes (blake2b, not Python's salted ``hash``)
    so traces and differential runs replay bit-identically.  Returns one
    int per full block; a trailing partial block yields nothing.
    """
    if tokens is None or block_size <= 0:
        return ()
    toks = [int(t) for t in tokens]
    n_full = len(toks) // block_size
    out = []
    prev = _SEED
    for i in range(n_full):
        blk = toks[i * block_size:(i + 1) * block_size]
        h = hashlib.blake2b(digest_size=8)
        h.update(prev)
        h.update(b",".join(str(t).encode() for t in blk))
        prev = h.digest()
        out.append(int.from_bytes(prev, "big"))
    return tuple(out)


@dataclass
class PrefixEntry:
    """One indexed block: who introduced it and who currently maps it."""

    block: int
    owner: int | None                       # mapping_id that allocated it
    sharers: set = field(default_factory=set)   # live mapping_ids (incl. owner)


@dataclass
class DetachResult:
    exited: bool = False          # last sharer left; block left its set
    was_orphan: bool = False      # owner had already detached earlier
    newly_orphaned: bool = False  # this detach was the owner leaving


class PrefixIndex:
    """hash → sharing-set entry, with reverse block → hash lookup."""

    def __init__(self):
        self._entries: dict[int, PrefixEntry] = {}
        self._by_block: dict[int, int] = {}
        self._owned: dict[int, int] = {}      # mapping_id → entries it owns

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, h: int) -> bool:
        return h in self._entries

    def match(self, hashes) -> list:
        """Longest-prefix match: blocks for the leading run of known hashes."""
        out = []
        for h in hashes:
            e = self._entries.get(h)
            if e is None:
                break
            out.append(e.block)
        return out

    def insert(self, h: int, block: int, mapping_id: int) -> None:
        """Index a freshly allocated block under ``h`` with ``mapping_id``
        as owner and sole sharer."""
        if h in self._entries:
            raise ValueError(f"hash {h:#x} already indexed")
        if block in self._by_block:
            raise ValueError(f"block {block} already indexed")
        self._entries[h] = PrefixEntry(block=block, owner=mapping_id,
                                       sharers={mapping_id})
        self._by_block[block] = h
        self._owned[mapping_id] = self._owned.get(mapping_id, 0) + 1

    def attach(self, block: int, mapping_id: int) -> None:
        """Record ``mapping_id`` as a sharer of an already-indexed block."""
        e = self._entries[self._by_block[block]]
        e.sharers.add(mapping_id)

    def detach(self, block: int, mapping_id: int) -> DetachResult:
        """Remove one sharer; drops the entry when the set empties.

        The caller (the memory manager) pairs this 1:1 with a tracker
        decref and recomputes the sharer mask from ``sharers_of``.
        """
        h = self._by_block[block]
        e = self._entries[h]
        e.sharers.discard(mapping_id)
        res = DetachResult(was_orphan=e.owner is None)
        if e.owner == mapping_id:
            e.owner = None
            res.newly_orphaned = True
            self._owned[mapping_id] = self._owned.get(mapping_id, 1) - 1
            if self._owned[mapping_id] <= 0:
                self._owned.pop(mapping_id, None)
        if not e.sharers:
            del self._entries[h]
            del self._by_block[block]
            res.exited = True
            res.newly_orphaned = False    # exit supersedes orphaning
        return res

    def sharers_of(self, block: int) -> set:
        h = self._by_block.get(block)
        return set(self._entries[h].sharers) if h is not None else set()

    def is_indexed(self, block: int) -> bool:
        return block in self._by_block

    def owned_by(self, mapping_id: int) -> int:
        """Entries this mapping introduced and still owns (admission uses
        this to tell reservation-covered shared blocks from residual)."""
        return self._owned.get(mapping_id, 0)

    @property
    def live_blocks(self) -> int:
        return len(self._by_block)

    @property
    def orphaned_live(self) -> int:
        return sum(1 for e in self._entries.values() if e.owner is None)


@dataclass
class PrefixStats:
    """Counters behind the ``fpr.prefix.`` metrics namespace."""

    lookups: int = 0            # mmap calls that consulted the index
    hit_blocks: int = 0         # blocks attached via a prefix hit
    miss_blocks: int = 0        # hashed full blocks allocated fresh
    cow_copies: int = 0         # copy-on-write divergences
    sharing_exits: int = 0      # blocks that left their sharing set
    shared_detaches: int = 0    # detaches that kept the block in its set
    evict_pinned: int = 0       # eviction victims skipped (refcount >= 2)
    exit_fenced: int = 0        # ex-shared blocks whose first reuse fenced
    exit_elided: int = 0        # ex-shared blocks whose first reuse elided
    in_set_violations: int = 0  # refcounted blocks seen at alloc/free (bug!)

    def counters(self, index: PrefixIndex) -> dict:
        total = self.hit_blocks + self.miss_blocks
        return {"lookups": self.lookups,
                "hit_blocks": self.hit_blocks,
                "miss_blocks": self.miss_blocks,
                "hit_rate": (round(self.hit_blocks / total, 4)
                             if total else 0.0),
                "cow_copies": self.cow_copies,
                "sharing_exits": self.sharing_exits,
                "shared_detaches": self.shared_detaches,
                "evict_pinned": self.evict_pinned,
                "exit_fenced": self.exit_fenced,
                "exit_elided": self.exit_elided,
                "indexed_live": index.live_blocks,
                "orphaned_live": index.orphaned_live,
                "in_set_violations": self.in_set_violations}
