"""Device-facing paged KV cache bound to the FPR memory manager (port of
``repro.serving.kv_cache``: the pools are torch tensors on the engine's
device, updated in place).

The split of responsibilities mirrors the paper exactly:

  * ``FprMemoryManager`` (core/) is the *kernel*: physical block ownership,
    recycling tracking, fence policy, eviction.
  * ``PagedKVCache`` is the *device side*: the pools live as tensors, and
    the per-step (tables, lengths) tensors are assembled from the manager's
    mappings.  A coherence fence invalidates device table copies (epoch
    bump); the cache subscribes to :class:`~repro_torch.core.events.FenceIssued`
    on the stack's event bus and its handler drains in-flight computation
    and re-uploads the tables — the TLB-flush analogue whose cost FPR
    avoids (each refresh is published back as
    :class:`~repro_torch.core.events.ShardRefreshed`).

**Shard-native device tables.**  The device block-table lives as ONE
stacked ``(num_workers, Bs, M)`` int32 array (``state["tables"]``): shard
``w`` is slice ``[w]`` and holds the batch slots with ``slot % W == w`` at
local row ``slot // W`` (``Bs = ceil(max_batch / W)``; slots past
``max_batch`` pad with ``-1`` and are never read).  The decode kernels
walk this stack *directly* (see ``kernels/paged_attention``) — there is no
monolithic kernel tensor and therefore no O(full-table) assemble anywhere:
a per-step update or a scoped fence refresh is one in-place
``tables[w].copy_`` per touched shard, and the engine binds each slot to its serving
worker at admission (:meth:`bind_slot_worker`) so a *scoped* fence
re-uploads the covered workers' own shards plus the shards of every slot
bound to them.  A *global* fence (``workers=None``) falls back to
re-uploading every shard, reproducing the broadcast pessimism the paper
eliminates.  The per-shard refresh counters (``device_refreshed_entries/
bytes``, ``device_shard_refreshes``, ``device_full_refreshes``) are what
the benchmarks diff between the global and sharded paths.

**Elastic resharding.**  :meth:`reshard` changes the worker topology of a
*live* cache: the manager carries masks/epochs/slots across (see
``core/fpr.py``), the cache repartitions the stacked array — re-deriving
authoritative rows only for the slots whose shard owner *moved* — and the
manager's scoped ``reason="reshard"`` fence (fired only when live rows
moved) bumps the old owners' epochs.  The cache skips its own device
refresh for that one fence (``_in_reshard``): the repartition that just
ran *is* the refresh, already counted under the ``device.reshard_*``
counters, so refreshed bytes scale with the moved fraction instead of a
full-table cold start.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.block_table import Mapping
from repro_torch.core.config import FprConfig
from repro_torch.core.contexts import ContextRegistry, ContextScope
from repro_torch.core.events import (EventBus, FenceIssued, ShardRefreshed,
                               SwapDropped, TopologyChanged)
from repro_torch.core.fpr import FprMemoryManager
from repro_torch.core.prefix import block_hashes
from repro_torch.core.shootdown import FenceCostModel, FenceEngine
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


class PagedKVCache:
    def __init__(self, cfg: ModelConfig, num_blocks: int, max_batch: int,
                 max_seq_len: int, *, fpr_enabled: bool = True,
                 scope: ContextScope = ContextScope.PER_GROUP,
                 dtype=torch.float32, device="cuda", num_workers: int = 1,
                 islands=None,
                 scoped_fences: bool = True,
                 prefix_sharing: bool = True,
                 cost_model: FenceCostModel | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.block_size = tfm.BLOCK_SIZE
        self.max_batch = max_batch
        self.max_blocks_per_seq = -(-max_seq_len // self.block_size)
        self.bus = EventBus()
        self.fences = FenceEngine(cost_model=cost_model,
                                  num_workers=num_workers,
                                  scoped=scoped_fences, bus=self.bus)
        # The manager subscribes its table-epoch bump first (coherence
        # order: host epochs move before the device shards refresh).
        self.mgr = FprMemoryManager(
            config=FprConfig(num_blocks=num_blocks, num_workers=num_workers,
                             islands=islands,
                             max_seqs=max_batch * 4,
                             max_blocks_per_seq=self.max_blocks_per_seq,
                             fpr_enabled=fpr_enabled,
                             scoped_fences=scoped_fences,
                             prefix_sharing=prefix_sharing),
            fence_engine=self.fences)
        self.metrics = self.mgr.metrics
        self.metrics.register("device", self._device_metrics)
        self.num_workers = num_workers
        self.contexts = ContextRegistry(default_scope=scope)
        self.fpr_enabled = fpr_enabled
        # device pools (decode-state pytree minus tables/lengths)
        spec = tfm.cache_spec(cfg, max_batch, max_seq_len,
                              num_blocks=num_blocks, dtype=dtype)
        self.state = {k: torch.zeros(sh, dtype=dt, device=self.device)
                      for k, (sh, dt) in spec.items()}
        # mirror of the last-uploaded device table (scheduler-slot space) —
        # what the device currently holds, used to diff per-step uploads
        self._host_tables = np.full(
            (max_batch, self.max_blocks_per_seq), -1, np.int32)
        # last known slot → mapping binding (refreshed by update_tables);
        # the fence path re-derives authoritative rows from the *live*
        # mapping state, so a mid-step fence uploads post-fence tables
        # rather than re-broadcasting the previous step's rows
        self._slot_mappings: dict[int, Mapping] = {}
        self._init_shard_layout(num_workers)
        self.state["tables"] = self._stack_from_host()
        self.state["lengths"] = torch.zeros(max_batch, dtype=torch.int32,
                                            device=self.device)
        self._fence_drains = 0
        # the engine's span recorder while its tracing is on
        # (core/recorder.py): fences and drains become spans
        self._rec = None
        self._full_refreshes = 0        # global fences: every shard re-upload
        self._shard_refreshes = 0       # scoped fences: masked shards only
        self._refreshed_entries = 0     # table entries re-uploaded by fences
        self._refreshed_bytes = 0
        self._step_upload_entries = 0   # normal-path (non-fence) shard uploads
        self._reshards = 0              # elastic topology changes applied
        self._reshard_moved_entries = 0
        self._reshard_refreshed_bytes = 0
        self._in_reshard = False
        # Per-island replica groups (numaPTE): a scoped fence re-uploads
        # in full only the shards inside the covered islands; shards it
        # must bump in *remote* islands take the delta-propagation path
        # (same data lands on the device, accounted apart so the
        # cross-island refreshed-bytes win is measurable).  Materialised
        # lazily on the first multi-island fence; None keeps flat
        # snapshots key-identical to the pre-island cache.
        self._island_device: "dict | None" = None
        # swap "device": evicted block contents round-trip through host
        # memory (the storage behind the page cache; latency is real)
        self._swap_store: dict = {}
        # "kv" is the fused head-interleaved K/V pool — swap, COW
        # divergence and shard refresh all move ONE contiguous array per
        # block instead of separate K and V halves
        self._pool_keys = [k for k in self.state
                           if k in ("kv", "mla_c", "mla_rope")]
        self.mgr.on_swap_out = self._swap_out
        self.mgr.on_swap_in = self._swap_in
        # event-bus subscriptions: the measured device-shard refresh runs on
        # every fence (after the manager's epoch bump, which subscribed
        # first), topology changes repartition the shard stack, and dying
        # mappings' swap-store copies are dropped
        self.bus.subscribe(FenceIssued, self._on_fence_issued)
        self.bus.subscribe(TopologyChanged, self._on_topology_changed)
        self.bus.subscribe(SwapDropped, self._handle_swap_dropped)

    # --------------------------------------------------------- shard layout
    def _init_shard_layout(self, num_workers: int) -> None:
        """(Re)build the interleaved slot→shard partition for ``W`` workers.

        Shard ``w`` owns slots ``w, w+W, w+2W, …``; the stacked device
        array is ``(W, Bs, M)`` with ``Bs = ceil(max_batch / W)`` (tail
        rows of ragged shards stay ``-1`` and are never addressed — the
        kernels index slots ``< max_batch`` only).
        """
        self.num_shards = max(1, num_workers)
        self.shard_rows = -(-self.max_batch // self.num_shards)   # Bs
        self._shard_slots = [
            np.arange(w, self.max_batch, self.num_shards, dtype=np.int64)
            for w in range(self.num_shards)]
        # which worker currently serves each batch slot (the engine rebinds
        # this at admission; defaults to the slot-modulo shard layout) —
        # scoped refreshes cover the shards of every slot a covered worker
        # serves, so non-slot routings (stream affinity) stay sound
        self._slot_worker = np.arange(self.max_batch,
                                      dtype=np.int64) % self.num_shards

    def _pad_shard_rows(self, rows: np.ndarray) -> np.ndarray:
        """Pad a shard's real rows to the uniform (Bs, M) slice shape
        (ragged tail rows stay -1 and are never addressed)."""
        if len(rows) == self.shard_rows:
            return rows
        padded = np.full((self.shard_rows, self.max_blocks_per_seq), -1,
                         np.int32)
        padded[:len(rows)] = rows
        return padded

    def _drain(self) -> None:
        """Wait for in-flight device work (the fence drain); the CPU runs
        eagerly, so there is nothing to wait for there."""
        rec = self._rec
        if rec is not None:
            rec.open("cache.fence.drain")
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        if rec is not None:
            rec.close()

    def _upload_shard(self, w: int, rows: np.ndarray) -> None:
        """Overwrite device shard ``w`` in place with ``rows`` (padded)."""
        self.state["tables"][w].copy_(
            torch.from_numpy(self._pad_shard_rows(rows)))

    def _stack_from_host(self) -> torch.Tensor:
        """Fresh (W, Bs, M) device stack from the host mirror (construction
        and reshard only — steady-state updates are per-shard slices)."""
        stack = np.stack([
            self._pad_shard_rows(self._host_tables[self._shard_slots[w]])
            for w in range(self.num_shards)])
        return torch.as_tensor(stack, dtype=torch.int32, device=self.device)

    def _on_fence_issued(self, evt: FenceIssued) -> None:
        if self._in_reshard and evt.reason == "reshard":
            # the repartition that triggered this fence already uploaded
            # authoritative tables for every moved row (counted under the
            # device.reshard_* counters) — re-uploading here would bill
            # the topology change twice
            return
        self._device_fence(evt.reason, evt.n_blocks, evt.workers)

    def _handle_swap_dropped(self, evt: SwapDropped) -> None:
        """Mapping destroyed with this block swapped out — free the copy."""
        self._swap_store.pop((evt.mapping_id, evt.logical_idx), None)

    def _swap_out(self, mid: int, idx: int, phys: int) -> None:
        self._swap_store[(mid, idx)] = {
            key: self.state[key][:, phys].to("cpu", copy=True)
            for key in self._pool_keys}

    def _swap_in(self, mid: int, idx: int, phys: int) -> None:
        data = self._swap_store.pop((mid, idx), None)
        if data is None:
            return
        for key, rows in data.items():
            self.state[key][:, phys] = rows.to(self.device)

    # -------------------------------------------------- measured fence cost
    def bind_slot_worker(self, slot: int, worker: int) -> None:
        """Record which worker serves ``slot`` (engine routing update)."""
        self._slot_worker[slot] = int(worker) % self.num_shards

    def _shards_of(self, workers) -> list[int]:
        """Worker ids → device-table shard indices to refresh.

        Covers the workers' own shards plus the shard of every batch slot
        currently bound to a covered worker — under non-slot routing a
        worker's rows can live outside its modulo shard, and those rows are
        exactly what its in-flight dispatches captured.
        """
        covered = {int(w) % self.num_shards for w in workers}
        shards = set(covered)
        bound = np.nonzero(np.isin(self._slot_worker,
                                   np.asarray(sorted(covered))))[0]
        shards.update(int(s) % self.num_shards for s in bound)
        return sorted(shards)

    def _live_row(self, slot: int) -> np.ndarray:
        """Authoritative table row for ``slot`` from live mapping state."""
        row = np.full(self.max_blocks_per_seq, -1, np.int32)
        m = self._slot_mappings.get(int(slot))
        if m is not None and m.mapping_id in self.mgr.tables.mappings:
            self._fill_row(row, m)
        return row

    def _device_fence(self, reason: str, n_blocks: int,
                      workers=None) -> None:
        """Drain in-flight steps + re-upload table shards (shootdown cost).

        A global fence (``workers is None``) re-uploads *every* shard — the
        paper's broadcast pessimism.  A scoped fence re-uploads only the
        shards of the workers it covered; everyone else's device copy stays
        valid (their shard epoch did not move), so refreshed bytes scale
        with the fence's mask popcount instead of the worker count.
        """
        rec = self._rec
        if rec is not None:
            rec.open("cache.fence", {"reason": reason, "n_blocks": n_blocks})
        self._drain()
        shards = (range(self.num_shards) if workers is None
                  else self._shards_of(workers))
        # Per-island replica groups: under a multi-island topology a
        # *scoped* fence splits its shard set — shards inside the covered
        # islands re-upload in full, shards pulled in from remote islands
        # (foreign-slot bindings under non-slot routing) receive a
        # delta-propagated update instead: the same authoritative rows
        # land on the device (token identity), but the transfer is the
        # compact remote-shootdown delta, billed to device.island.* and
        # excluded from refreshed_bytes.
        topo = self.mgr.topology
        remote: set = set()
        if topo is not None and workers is not None:
            cov_isl = set(topo.islands_of(int(w) % self.num_shards
                                          for w in workers))
            remote = {int(w) for w in shards
                      if topo.island_of(int(w)) not in cov_isl}
        # Authoritative post-fence rows: re-derive from the mappings that
        # are still live in the manager (a fence can fire mid-step — after
        # an alloc/evict/free but before the next update_tables — so the
        # last-uploaded mirror lags reality).  Only the covered shards'
        # slots are rebuilt: host-side fence work scales with the mask
        # popcount, like the upload it feeds.
        entries = nbytes = 0
        d_entries = d_bytes = 0
        for w in shards:
            slots = self._shard_slots[w]
            rows = np.stack([self._live_row(s) for s in slots]) \
                if len(slots) else np.zeros((0, self.max_blocks_per_seq),
                                            np.int32)
            if int(w) in remote:
                # delta propagation: only the rows that differ from the
                # remote replica's current copy travel the interconnect
                diff = int((rows != self._host_tables[slots]).sum()) \
                    if len(slots) else 0
                d_entries += diff
                d_bytes += diff * rows.itemsize
            else:
                entries += rows.size
                nbytes += rows.nbytes
            self._host_tables[slots] = rows              # device now has them
            self._upload_shard(w, rows)
        self._refreshed_entries += entries
        self._refreshed_bytes += nbytes
        if topo is not None and workers is not None:
            if self._island_device is None:
                self._island_device = {"intra_refreshes": 0,
                                       "remote_deltas": 0,
                                       "delta_entries": 0,
                                       "delta_bytes": 0}
            st = self._island_device
            st["intra_refreshes"] += len(shards) - len(remote)
            st["remote_deltas"] += len(remote)
            st["delta_entries"] += d_entries
            st["delta_bytes"] += d_bytes
        self._fence_drains += 1
        if workers is None:
            self._full_refreshes += 1
        else:
            self._shard_refreshes += 1
        if self.bus.wants(ShardRefreshed):
            self.bus.publish(ShardRefreshed(
                reason=reason, shards=tuple(int(s) for s in shards),
                entries=entries + d_entries, nbytes=nbytes + d_bytes,
                full=workers is None))
        if rec is not None:
            rec.close()

    # ------------------------------------------------------------- reshard
    @property
    def topology(self):
        """The installed multi-island topology, ``None`` when flat."""
        return self.mgr.topology

    def reshard(self, new_num_workers: int, translation=None) -> dict:
        """Elastic topology change on a *live* cache (drain-free for every
        row that does not move shards).

        Delegates the host-side remap (masks, epochs, slots, free lists,
        ledgered overflow records) to :meth:`FprMemoryManager.reshard`;
        the cache's own work happens in the :class:`TopologyChanged`
        subscriber, which runs *before* the manager's scoped reshard fence
        so the fence's epoch bump lands on the new layout.  Returns the
        manager's reshard plan.
        """
        return self._reshape_impl(new_num_workers, translation, None)

    def reshape(self, topology, translation=None) -> dict:
        """Elastic *hierarchical* topology change: reshard onto the
        topology's worker count AND install its island partition in the
        same sync point (islands join/leave live).  A flat spec is exactly
        :meth:`reshard`."""
        from repro_torch.core.topology import Topology
        topo = Topology.of(topology)
        # the topology is passed explicitly even when flat — reshape
        # semantics are "install THIS partition", so a flat spec clears a
        # previously multi-island layout (reshard's None keeps whatever
        # survives the count change instead)
        return self._reshape_impl(topo.num_workers, translation, topo)

    def _reshape_impl(self, new_num_workers: int, translation,
                      topology) -> dict:
        if translation is None:
            translation = self.mgr.default_translation(new_num_workers)
        self._drain()                                    # topology sync point
        # the cache's slot space is the decode batch, distinct from the
        # store's table-slot space: the (translated) old owners losing
        # *live batch rows* join the manager's single reshard fence
        alive = self.mgr.tables.mappings
        extra = {int(translation[s % self.num_shards])
                 for s in self._moved_batch_slots(new_num_workers,
                                                  translation)
                 if (m := self._slot_mappings.get(int(s))) is not None
                 and m.mapping_id in alive}
        self._in_reshard = True
        try:
            plan = self.mgr.reshard(new_num_workers, translation,
                                    extra_fence_workers=sorted(extra),
                                    topology=topology)
        finally:
            self._in_reshard = False
        return plan

    def _moved_batch_slots(self, new_num_workers: int,
                           translation) -> list[int]:
        """Batch slots whose device-shard owner changes under the reshard
        (``translation[s % W_old] != s % W_new``)."""
        old_w = self.num_shards
        return [s for s in range(self.max_batch)
                if int(translation[s % old_w]) != s % new_num_workers]

    def _on_topology_changed(self, evt: TopologyChanged) -> None:
        """Repartition the device shard stack onto the new worker set.

        Only the *moved* slots' rows are re-derived from live mapping
        state and counted as reshard refresh traffic — every other row's
        device copy is carried over byte-for-byte (in a real deployment
        the unmoved shards are simply not re-broadcast; here the stack is
        rebuilt from the mirror, which holds exactly what the device
        holds).  Refreshed bytes therefore scale with the moved fraction,
        strictly below one full-table re-upload whenever any row stays.
        """
        W = evt.new_num_workers
        trans = evt.translation
        # moved rows in the cache's own slot space (the decode batch) —
        # the event's moved_slots are store-table slots, a different space
        moved = self._moved_batch_slots(W, trans)
        old_slot_worker = self._slot_worker
        self._init_shard_layout(W)
        # carry engine routing through the translation (the engine rebinds
        # per its own policy right after resize_workers)
        self._slot_worker = np.asarray(
            [trans[int(w)] if int(w) < len(trans) else int(w) % W
             for w in old_slot_worker], dtype=np.int64) % W
        self.num_workers = W
        for s in moved:                      # authoritative data for movers
            self._host_tables[s] = self._live_row(s)
        self.state["tables"] = self._stack_from_host()
        row_bytes = self._host_tables[0].nbytes
        self._reshards += 1
        self._reshard_moved_entries += len(moved) * self.max_blocks_per_seq
        self._reshard_refreshed_bytes += len(moved) * row_bytes

    # ------------------------------------------------------- prefix sharing
    @property
    def prefix_sharing(self) -> bool:
        return self.mgr.prefix_sharing

    def prefix_hashes(self, prompt_tokens) -> tuple:
        """Chain hashes of the prompt's full token blocks (empty when
        sharing is off — callers can pass the result straight through)."""
        if not self.prefix_sharing:
            return ()
        return block_hashes(prompt_tokens, self.block_size)

    def probe_prefix(self, hashes) -> int:
        """How many leading blocks a request with these hashes would attach
        to *right now* (the admission governor's unique-block estimate)."""
        if not self.prefix_sharing or not hashes:
            return 0
        return len(self.mgr.prefix.match(hashes))

    def ensure_private(self, m: Mapping, logical_idx: int, *,
                       worker: int = 0) -> bool:
        """Copy-on-write before a divergent write into a shared block.

        If the mapping's block at ``logical_idx`` is shared with other
        live sharers, allocate a private copy, duplicate the KV pool rows
        (old block → new block, the actual copy of copy-on-write), and
        repoint the mapping.  Returns True iff a copy was made.  The old
        block stays inside its sharing set — no fence (see
        :meth:`FprMemoryManager.cow`).
        """
        res = self.mgr.cow(m.mapping_id, logical_idx, worker=worker)
        if res is None:
            return False
        old, new = res
        for key in self._pool_keys:
            self.state[key][:, new] = self.state[key][:, old]
        return True

    # ---------------------------------------------------------- allocation
    def alloc_sequence(self, n_tokens: int, *, stream: str = "default",
                       group_id: int | None = None,
                       use_fpr: bool | None = None,
                       worker: int = 0, prefix_hashes=()) -> Mapping:
        n_blocks = max(1, -(-n_tokens // self.block_size))
        gid = group_id if group_id is not None else 1
        ctx = self.contexts.resolve(
            group_id=gid, stream_name=stream,
            use_fpr=self.fpr_enabled if use_fpr is None else use_fpr)
        return self.mgr.mmap(n_blocks, ctx, worker=worker,
                             prefix_hashes=prefix_hashes)

    def extend_sequence(self, m: Mapping, n_blocks: int = 1, *,
                        worker: int = 0) -> None:
        self.mgr.extend(m.mapping_id, n_blocks, worker=worker)

    def free_sequence(self, m: Mapping, *, worker: int = 0) -> None:
        self.mgr.munmap(m.mapping_id, worker=worker)

    # ------------------------------------------------------- device tensors
    def _fill_row(self, row: np.ndarray, m: Mapping) -> None:
        """Write a mapping's physical blocks into a (pre-cleared) table row."""
        n = min(len(m.physical), self.max_blocks_per_seq)
        row[:n] = [b if b >= 0 else -1 for b in m.physical[:n]]

    def _host_rows(self, mappings: dict[int, Mapping]) -> np.ndarray:
        """Host (max_batch, M) table from slot → mapping."""
        tab = np.full((self.max_batch, self.max_blocks_per_seq), -1,
                      np.int32)
        for slot, m in mappings.items():
            self._fill_row(tab[slot], m)
        return tab

    def slot_tables(self, mappings: dict[int, Mapping]) -> torch.Tensor:
        """A standalone (max_batch, M) device table (prefill temp views)."""
        return torch.as_tensor(self._host_rows(mappings), device=self.device)

    def update_tables(self, mappings: dict[int, Mapping],
                      lengths: np.ndarray) -> None:
        """Per-step table update: upload only the shards whose rows changed
        — each one an in-place copy into the stacked device array; the
        kernels consume the stack directly, so nothing is assembled."""
        if self._rec is not None:
            self._rec.phase("engine.tables")
        self._slot_mappings = dict(mappings)
        host = self._host_rows(mappings)
        for w, slots in enumerate(self._shard_slots):
            rows = host[slots]
            if not np.array_equal(rows, self._host_tables[slots]):
                self._upload_shard(w, rows)
                self._step_upload_entries += rows.size
        self._host_tables = host
        self.state["lengths"] = torch.as_tensor(lengths, dtype=torch.int32,
                                                device=self.device)

    def _device_metrics(self) -> dict:
        d = {"fence_drains": self._fence_drains,
             "table_shards": self.num_shards,
             "full_refreshes": self._full_refreshes,
             "shard_refreshes": self._shard_refreshes,
             "refreshed_entries": self._refreshed_entries,
             "refreshed_bytes": self._refreshed_bytes,
             "reshards": self._reshards,
             "reshard_moved_entries": self._reshard_moved_entries,
             "reshard_refreshed_bytes": self._reshard_refreshed_bytes,
             "step_upload_entries": self._step_upload_entries}
        if self._island_device is not None:
            d["island"] = dict(self._island_device)
        return d
