"""Serving engine: continuous batching over the FPR paged cache.

Port of ``repro.serving.engine`` onto torch tensors.  The reference's
four ``jax.jit`` closures become direct calls; ``prefill_traces`` and
``prefill_chunk_traces`` count the distinct input-shape signatures each
path has seen (what a jit retrace counts), so the one-shape contract of
the chunk and ragged paths still reads 1.  The decode and ragged paths
run the CUDA paged-attention kernels under ``page_impl="kernel"``.

The request lifecycle drives exactly the paper's two fence sources:

  * **mmap–munmap cycles** — admission allocates a sequence's blocks
    (mmap), completion frees them (munmap).  Baseline: one batched fence
    per free.  FPR: the fence is skipped; the blocks recycle to the next
    request of the stream, and a fence fires only if they ever leave the
    recycling context.
  * **eviction** — under pool pressure a watermark daemon (kswapd) swaps
    victim blocks out; FPR defers and batches those fences (§IV-B).

``fpr_enabled=False`` gives the stock-Linux baseline; both modes must
produce **identical tokens** (tests/test_serving.py asserts it), because
FPR only moves *when* invalidation happens, never what the tables say.

**Admission control.**  ``admission=`` attaches a
:class:`~repro_torch.serving.admission.MemoryGovernor` between the scheduler
and the cache: queued sequences are admitted only when the capacity
ledger can commit their whole attention window, ordered by the configured
policy (FCFS / recycle-affinity / priority).  With the governor on, a
demand-pager give-up is impossible at ``overcommit_ratio=1`` and triggers
preemption (recompute or swap-through-the-evictor victims) instead of
shipping ``-1`` rows at higher ratios; the legacy path (``admission=None``)
keeps the ``demand_pager_gave_up`` counter behaviour.
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from repro_torch.core.config import validate_translation, validate_worker_count
from repro_torch.core.eviction import WatermarkEvictor
from repro_torch.core.events import (FenceIssued, PrefillChunkDone,
                               PreemptionResolved, PreemptionStarted,
                               RequestCompleted, ShardRefreshed,
                               StepCompleted)
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.serving.admission import CapacityError, MemoryGovernor
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.scheduler import Request, Scheduler


def _signature(args) -> tuple:
    """Shapes and dtypes of a call's tensor arguments (dicts by key) —
    the key a jit cache would retrace on."""
    sig = []
    for a in args:
        if isinstance(a, dict):
            sig.append(tuple((k, _signature([v])) for k, v in sorted(a.items())))
        else:
            sig.append((tuple(a.shape), a.dtype))
    return tuple(sig)


class Engine:
    """Continuous-batching engine over the FPR paged cache.

    Construction: ``Engine(cfg, params, config=EngineConfig(...))`` — the
    only construction path (the one-release loose-kwargs window closed;
    stray keyword arguments raise ``TypeError``).

    The engine shares one :class:`~repro_torch.core.events.EventBus` with its
    cache, fence engine, memory manager and governor (:attr:`bus`), and one
    :class:`~repro_torch.core.metrics.MetricsRegistry` (:attr:`metrics`) whose
    flat snapshot (``engine.metrics.snapshot()``) is the canonical — and
    only — counter surface.

    **Elastic topology.**  :meth:`resize_workers` reshards a *live* engine
    to a new worker count without draining the request queue or dropping a
    mapping: the cache/manager carry every per-worker structure across
    (see ``core/shootdown.py`` for the soundness argument), the admission
    ledger's per-worker commitments are remapped, and running slots are
    re-bound to their new serving workers.  Tokens are bit-identical to a
    fixed-topology run (``benchmarks/engine_trace.py`` elastic replay).
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 config: EngineConfig | None = None):
        config = config or EngineConfig()
        self.config = config
        self.cfg = cfg
        self.params = params
        self.page_impl = config.page_impl
        self.eos = config.eos_token
        self.greedy = config.greedy
        self.cache = PagedKVCache(
            cfg, config.num_blocks, config.max_batch, config.max_seq_len,
            fpr_enabled=config.fpr_enabled, scope=config.scope,
            dtype=config.dtype, device=config.device,
            num_workers=config.num_workers,
            islands=config.islands,
            scoped_fences=config.scoped_fences,
            cost_model=config.cost_model,
            prefix_sharing=config.prefix_sharing)
        self.bus = self.cache.bus
        self.metrics = self.cache.metrics
        self.worker_routing = config.worker_routing
        self.sched = Scheduler(config.max_batch)
        gcfg = config.governor_config()
        if gcfg is None:
            self.governor = None
        else:
            self.governor = MemoryGovernor(
                config.num_blocks, self.cache.block_size,
                num_workers=config.num_workers, config=gcfg, bus=self.bus)
            # per-island ledger aggregation follows the cache's topology
            self.governor.topology = self.cache.topology
            # prefix-sharing hooks: admission reserves only the estimated
            # unique remainder of a window, and charges capacity for
            # indexed blocks no running reservation covers (see
            # MemoryGovernor.window_blocks / fits)
            self.governor.probe_shared = (
                lambda r: self.cache.probe_prefix(r.prefix_hashes))
            self.governor.shared_residual = self._shared_residual
        self.metrics.register("admission", self._admission_metrics)
        self.metrics.register("engine", self._engine_metrics)
        # Observability histograms (schema-pinned; see HISTOGRAM_SCHEMA).
        # All five exist on every engine so the snapshot key set is
        # topology- and governor-independent; the fence/device ones are
        # fed straight off the coherence event stream.
        self._hist_step = self.metrics.histogram("engine.obs.step_latency_s")
        self._hist_queue_wait = self.metrics.histogram(
            "engine.obs.queue_wait_steps")
        hist_depth = self.metrics.histogram("admission.obs.queue_depth")
        hist_scope = self.metrics.histogram("fence.obs.scope_workers")
        hist_refresh = self.metrics.histogram("device.obs.refresh_bytes")
        # each observation carries the nearest trace/span id as its
        # exemplar so a latency bucket links back to the Chrome-trace /
        # OpenMetrics exemplar that produced it (core/export.py renders
        # them; snapshot() output is exemplar-free)
        self.bus.subscribe(
            FenceIssued,
            lambda e: hist_scope.observe(len(e.workers)
                                         if e.workers is not None
                                         else self.cache.num_workers,
                                         exemplar=f"fence-{e.seq}"))
        self.bus.subscribe(ShardRefreshed,
                           lambda e: hist_refresh.observe(
                               e.nbytes, exemplar=f"refresh-{e.reason}"))
        if self.governor is not None:
            self.governor.observe_queue_depth = hist_depth.observe
        self.evictor = WatermarkEvictor(self.cache.mgr, self._lru_victims,
                                        watermarks=config.watermarks)
        self.metrics.register("fpr.eviction", self.evictor.counters)
        self.steps = 0
        # decode_step calls (one paged-decode kernel launch per attention
        # layer each); not in the snapshot, which stays the reference's
        self.decode_steps = 0
        self.tokens_generated = 0
        self.wall_s = 0.0
        # steps where the demand pager hit its pass bound with faults
        # still outstanding (over-committed pool): decoding proceeded
        # with non-resident rows squashed to -1 — tokens are suspect.
        self.demand_pager_gave_up = 0

        # Chunked prefill: the fixed-shape chunk path implements
        # attention-only decoder models; anything else falls back to
        # monolithic prefill (and the monolithic full-window admission
        # that goes with it).  Setting the governor's ``chunk_blocks``
        # switches admission to first-chunk-plus-tail reservations that
        # grow per chunk through ``on_extend``.
        self._chunked = (config.chunked_prefill
                         and all(m == "attn" for m in cfg.mixers)
                         and not cfg.enc_dec)
        self.chunk_tokens = config.prefill_chunk * self.cache.block_size
        self.prefill_chunks = 0
        # shape-signature sets, the counterpart of the reference's jit
        # retrace counters: the fixed-shape chunk and ragged paths hold
        # prefill_chunk_traces at 1 across mixed prompt lengths
        self._prefill_sigs: set = set()
        self._chunk_sigs: set = set()
        if self._chunked and self.governor is not None:
            self.governor.chunk_blocks = config.prefill_chunk

        # Ragged fused-KV serving: every slot's incoming tokens — prefill
        # chunks and decode rows alike — pack into ONE fixed-shape token
        # stream and one ragged kernel call per layer per step.  The
        # token capacity is static (max_batch rows, each padded to the
        # kernel's query-tile multiple), so the whole mixed step keeps
        # the chunk path's one-shape contract (prefill_chunk_traces).
        self._ragged = config.ragged_kernel and self._chunked
        self._kernel_calls = 0
        self._ragged_steps = 0
        self._kernel_dma_bytes = 0
        if self._ragged:
            from repro_torch.kernels.paged_attention.ops import QT
            seg = -(-self.chunk_tokens // QT) * QT
            self._t_cap = config.max_batch * seg


    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.cache.device)

    # ------------------------------------------------------------ lifecycle
    def submit(self, prompt, max_new_tokens: int, stream: str = "default",
               group_id: int = 1, priority: int = 0,
               sla: float | None = None) -> int:
        # prompt-block chain hashes are computed exactly once, here — the
        # governor's probe and the allocation both reuse them
        rid = self.sched.submit(prompt, max_new_tokens, stream, group_id,
                                priority, sla=sla,
                                prefix_hashes=self.cache.prefix_hashes(
                                    prompt))
        # queue-wait clock zero: the engine step this submit landed on
        self.sched.queue[-1].submit_step = self.steps
        if self.governor is not None:
            # fast-reject on the governor's own admissibility estimate, not
            # the raw prompt+budget window: a heavily shared long prompt
            # attaches its prefix blocks instead of allocating them, so the
            # shared-adjusted window is what bounds final residency — the
            # raw check wrongly refused prompts admissible_ever accepts
            # (and, under chunked admission, prompts the chunk machine can
            # serve within the limit)
            r = self.sched.queue[-1]
            if not self.governor.admissible_ever(r):
                self.sched.queue.pop()
                raise CapacityError(
                    f"request window of {self.governor.window_blocks(r)} "
                    f"blocks can never fit the admission limit of "
                    f"{self.governor.ledger.limit}")
        return rid

    def _lru_victims(self):
        """Eviction candidates over running sequences, never the block the
        next decode write lands in.

        The old ``range(m.num_blocks - 1)`` bound protected only the
        window's *last* block — but mid-decode the active block
        ``_used_blocks(r) - 1`` sits far below that, so the evictor could
        swap out the very block the next token writes into (the write
        would land on a ``-1`` row and silently drop).  Victims are
        yielded settled-history first (true LRU: coldest, already
        written), then the never-written window tail (pure allocation
        headroom — nothing to lose, which is what lets the legacy
        over-commit mode squeeze new windows in).  A chunked-prefill
        sequence yields nothing: every chunk's attention reads the whole
        written history and scatters into the freshly grown tail, so its
        entire mapping is active until promotion.
        """
        for slot in sorted(self.sched.running):
            r = self.sched.running[slot]
            m = r.mapping
            if m is None or r.state == "prefill":
                continue
            is_fpr = m.ctx_id != 0
            active = self._used_blocks(r) - 1
            for idx in range(m.num_blocks):
                if idx != active:
                    yield m.mapping_id, idx, is_fpr

    def _used_blocks(self, r: Request) -> int:
        """Blocks of ``r``'s window the next engine step will touch."""
        if r.state == "prefill":
            # every chunk attends the full written history and scatters
            # into the tail — the whole mapping must be resident
            return r.mapping.num_blocks
        return min(-(-r.length // self.cache.block_size),
                   r.mapping.num_blocks)

    def _worker_of(self, r: Request) -> int:
        """Request → worker (one 'core' per engine worker).

        ``slot`` routing pins a worker per batch slot (matches the device
        table shard layout exactly); ``stream`` routing gives every request
        stream a sticky worker, so a stream's recycling stays worker-local
        and its context-exit fences carry one-bit masks even when the
        scheduler moves the stream across slots.
        """
        if self.worker_routing == "stream":
            return zlib.crc32(r.stream.encode()) % self.cache.num_workers
        return r.slot % self.cache.num_workers

    # ------------------------------------------------------ elastic topology
    def resize_workers(self, new_num_workers: int,
                       translation=None) -> dict:
        """Reshard the live engine to ``new_num_workers`` (drain-free) —
        the flat special case of :meth:`reshape` (an explicit resize
        installs the single-island topology, clearing any island
        partition; pass a multi-island spec to :meth:`reshape` to keep
        hierarchy across a count change)."""
        from repro_torch.core.topology import Topology
        validate_worker_count(new_num_workers)
        return self.reshape(Topology.flat(new_num_workers), translation)

    def reshape(self, topology, translation=None) -> dict:
        """Reshard the live engine onto a (possibly hierarchical) worker
        topology — islands join/leave live, drain-free.

        ``topology`` is anything :meth:`Topology.of` accepts: a worker
        count (flat), an island spec (tuple of worker-id tuples), or a
        :class:`~repro_torch.core.topology.Topology`.  Order: the admission
        ledger's per-worker commitments remap first (capacity is governed
        through the topology change — total ``committed`` never moves, so
        the admission invariant holds throughout), then the cache/manager
        reshard carries masks, epochs, table shards and free lists across
        and installs the island partition on every coherence layer
        (issuing the scoped ``reason="reshard"`` fence iff live rows moved
        shards), and finally every running slot is re-bound to its serving
        worker under the *new* topology so future scoped refreshes stay
        covering.  Queued requests are untouched — no drain, no cold
        start.

        Returns the reshard plan (moved slots / fenced workers).
        """
        from repro_torch.core.topology import Topology
        topo = Topology.of(topology)
        new_num_workers = topo.num_workers
        validate_worker_count(new_num_workers)
        if translation is None:
            translation = self.cache.mgr.default_translation(new_num_workers)
        # reject malformed translations BEFORE the ledger (or any other
        # per-worker structure) is remapped — reshape applies fully or not
        # at all
        validate_translation(translation, self.cache.num_workers,
                             new_num_workers)
        if self.governor is not None:
            self.governor.reshard(new_num_workers, translation,
                                  topology=topo)
        plan = self.cache.reshape(topo, translation)
        self.config = self.config.replace(
            num_workers=new_num_workers,
            islands=None if topo.is_flat else topo.spec)
        for slot, r in self.sched.running.items():
            self.cache.bind_slot_worker(slot, self._worker_of(r))
        return plan

    def _admit(self) -> None:
        admitted = (self.sched.admit() if self.governor is None
                    else self._governed_admit())
        for r in admitted:
            if r.state != "running":
                # a later admission's allocation pressure preempted this
                # one before its turn — it re-queued and retries next round
                continue
            # queue wait in engine steps: deterministic virtual time from
            # (re-)enqueue to seating
            self._hist_queue_wait.observe(self.steps - r.submit_step,
                                          exemplar=f"req-{r.rid}")
            # device refresh scoping must know which worker serves the slot
            self.cache.bind_slot_worker(r.slot, self._worker_of(r))
            if r.mapping is not None:
                # swap-preempted re-admission: mapping and generated tokens
                # survived; the demand pager faults the blocks back in
                if self._chunked and r.prefill_pos < len(r.prompt):
                    # preempted mid-prefill (swap strategy): resume the
                    # chunk state machine where it left off
                    r.state = "prefill"
                continue
            if self._chunked:
                # admit on the current length: allocate the first chunk
                # plus one active tail block, never the whole window — the
                # mapping grows chunk-by-chunk (and per decode block)
                # through the governed extend path
                bs = self.cache.block_size
                full = max(1, -(-(len(r.prompt) + r.max_new_tokens) // bs))
                need = min(full, self.config.prefill_chunk + 1) * bs
                r.prefill_pos = 0
                r.state = "prefill"
            else:
                need = len(r.prompt) + r.max_new_tokens
            while True:
                try:
                    r.mapping = self.cache.alloc_sequence(
                        need, stream=r.stream, group_id=r.group_id,
                        worker=self._worker_of(r),
                        prefix_hashes=r.prefix_hashes)
                    break
                except Exception as e:
                    if self._make_room(r):
                        continue
                    if self.governor is not None:
                        raise CapacityError(
                            "admission cannot allocate "
                            f"{need} tokens of blocks: pool exhausted and "
                            "no eviction or preemption victim remains"
                        ) from e
                    raise
            # settle the probe-estimated reservation against the blocks
            # the mapping actually allocated (shared prefixes attach, not
            # allocate — only the unique remainder is committed)
            if self.governor is not None:
                m = r.mapping
                self._reserve_settle(
                    r, lambda: self.governor.on_allocated(
                        r, m.num_blocks - m.prefix_hits))
            if not self._chunked:
                self._prefill_request(r)
            # chunked requests stay in state "prefill": step() runs one
            # fixed-shape chunk per step until the prompt is covered

    def _make_room(self, r: Request) -> bool:
        """Free blocks under allocation pressure: evict, else (governed)
        preempt a victim other than ``r`` — the same escalation order the
        demand pager uses, so admission and fault-in fail identically."""
        if self.evictor.maybe_evict():
            return True
        if self.governor is not None and len(self.sched.running) > 1:
            victim = self.governor.choose_victim(self.sched.running,
                                                 exclude=(r.rid,))
            if victim is not None:
                self._preempt(victim)
                return True
        return False

    def _reserve_settle(self, r: Request, settle) -> None:
        """Apply a reservation adjustment for ``r`` (post-alloc reconcile,
        COW growth), preempting victims while the growth over-commits.
        The blocks themselves are already allocated — only the ledger
        needs room, and preemption is what frees committed windows."""
        gov = self.governor
        if gov is None or not gov.ledger.holds(r.rid):
            return
        while True:
            try:
                settle()
                return
            except CapacityError:
                victim = (gov.choose_victim(self.sched.running,
                                            exclude=(r.rid,))
                          if len(self.sched.running) > 1 else None)
                if victim is None:
                    raise
                self._preempt(victim)

    def _shared_residual(self) -> int:
        """Indexed live blocks covered by no running reservation.

        Every physical block must be charged against capacity exactly
        once: private blocks and owner-inserted prefix blocks by their
        sequence's reservation, attachments by the *owner's* reservation —
        and when the owner completed, was preempted, or diverged away
        (``SharingExit``/COW orphaned the entry), by this residual.  The
        governor folds it into :meth:`~repro_torch.serving.admission.governor.
        MemoryGovernor.fits`, so admission keeps the pager-fixpoint
        guarantee with sharing on."""
        prefix = self.cache.mgr.prefix
        live = prefix.live_blocks
        if not live:
            return 0
        ledger = self.governor.ledger
        covered = sum(
            prefix.owned_by(r.mapping.mapping_id)
            for r in self.sched.running.values()
            if r.mapping is not None and ledger.holds(r.rid))
        return max(0, live - covered)

    def _governed_admit(self) -> list[Request]:
        """Admission through the governor: policy order, capacity-checked.

        Priority pressure first: while the highest queued class is blocked
        on capacity and a strictly lower class is running, preempt the
        governor's victim (vLLM-style) — then fill free slots with the
        policy's picks until capacity or the queue runs out.
        """
        gov = self.governor
        while True:
            bi = gov.wants_priority_preempt(self.sched.queue)
            if bi is None:
                break
            victim = gov.choose_victim(
                self.sched.running,
                below_priority=self.sched.queue[bi].priority)
            if victim is None:
                break
            self._preempt(victim)
        admitted = []
        for slot in self.sched.admissible():
            idx = gov.select(self.sched.queue)
            if idx is None:
                break
            r = self.sched.queue.pop(idx)
            self.sched.place(r, slot)
            gov.on_admit(r, self._worker_of(r))
            admitted.append(r)
        return admitted

    def _preempt(self, r: Request, strategy: str | None = None) -> str:
        """Evict ``r`` from its slot per the governor's victim strategy.

        ``recompute`` frees the mapping (the blocks recycle — fence-free
        under FPR) and clears generated tokens for a from-scratch
        re-prefill; ``swap`` pushes the resident blocks out through the
        swap path (one merged fence, contents round-trip through the swap
        store) and keeps mapping + tokens for fault-back re-admission.
        Architectures with per-slot recurrent state cannot survive a slot
        change, so swap falls back to recompute there.  Returns the
        strategy actually applied.
        """
        gov = self.governor
        requested = strategy or gov.config.preempt
        self.bus.publish(PreemptionStarted(rid=r.rid, strategy=requested))
        strategy = requested
        if strategy == "swap" and r.mapping is None:
            # a victim admitted this round but not yet allocated has
            # nothing to swap — fall back to recompute (the port serves
            # attention-only models, which keep no per-slot recurrent
            # state)
            strategy = "recompute"
        worker = self._worker_of(r)
        gov.on_release(r)
        if strategy == "swap":
            m = r.mapping
            victims = [(m.mapping_id, i)
                       for i, b in enumerate(m.physical) if b >= 0]
            if victims:
                self.cache.mgr.evict(victims,
                                     fpr_batch=self.cache.fpr_enabled,
                                     worker=worker)
            self.sched.preempt(r, keep_mapping=True)
        else:
            self.sched.preempt(
                r, free=lambda m: self.cache.free_sequence(m, worker=worker))
        # the governor's preemption counters subscribe to this event
        self.bus.publish(PreemptionResolved(rid=r.rid, strategy=strategy))
        # the re-queued victim's queue-wait clock restarts at preemption
        r.submit_step = self.steps
        return strategy

    def _prefill_request(self, r: Request) -> None:
        """Single-sequence prefill into the request's blocks."""
        S = len(r.prompt)
        bs = self.cache.block_size
        Sp = max(bs, -(-S // bs) * bs)              # pad to block multiple
        toks = np.zeros((1, Sp), np.int32)
        toks[0, :S] = r.prompt
        view = dict(self.cache.state)
        view["tables"] = self.cache.slot_tables({0: r.mapping})[:1]
        view["lengths"] = self._tensor(np.zeros((1,), np.int32))
        toks = self._tensor(toks)
        self._prefill_sigs.add(_signature([toks, view]))
        # the pools are written in place
        logits, _ = tfm.prefill(self.params, self.cfg, toks, view)
        # first generated token comes from position S-1 (prefill is padded;
        # recompute the true last-token logits on the next decode step if
        # padding hid it — for simplicity prompts are block-aligned in
        # benchmarks; otherwise we decode from the argmax here)
        del logits

    def _prefill_chunk_step(self, r: Request) -> None:
        """One fixed-shape prefill chunk for ``r`` — the chunked state
        machine's single transition.

        Grows the reservation ahead of the chunk through the governor
        (``on_extend`` escalating evict → preempt → ``CapacityError``,
        exactly the admission ladder) and the mapping through the
        §IV-A-checked allocation path, runs the fixed-shape chunk at
        offset ``start`` (one input shape for every prompt length), and
        promotes the request to ``"running"`` once the prompt is covered.
        The policy may defer the growth for a step (``defer_growth``) to
        seat a more urgent queued request first — bounded, never a
        livelock.
        """
        if not self._grow_for_chunk(r):
            return                    # policy deferred this step's growth
        S = len(r.prompt)
        start = r.prefill_pos
        C = self.chunk_tokens
        m = r.mapping
        end = min(S, start + C)
        toks = np.zeros((1, C), np.int32)
        toks[0, :end - start] = r.prompt[start:end]
        view = dict(self.cache.state)
        view["tables"] = self.cache.slot_tables({0: m})[:1]
        view["lengths"] = self._tensor(np.zeros((1,), np.int32))
        toks = self._tensor(toks)
        self._chunk_sigs.add(("chunk",) + _signature([toks, view]))
        # the pools are written in place
        tfm.prefill_chunk(self.params, self.cfg, toks, view, start)
        r.prefill_pos = end
        self.prefill_chunks += 1
        if self.bus.wants(PrefillChunkDone):
            self.bus.publish(PrefillChunkDone(rid=r.rid, start=start,
                                              end=end, step=self.steps))
        if r.prefill_pos >= S:
            r.state = "running"    # decodes this very step (interleaved)

    def _grow_for_chunk(self, r: Request) -> bool:
        """Grow ``r``'s reservation and mapping ahead of its next prefill
        chunk — the growth half of :meth:`_prefill_chunk_step`, shared
        with the ragged pass.  Covers the chunk's tokens plus one active
        tail block, capped at the full window (which admission already
        proved can ever fit); returns False when the policy deferred the
        growth to seat a more urgent queued request first."""
        m = r.mapping
        bs = self.cache.block_size
        S = len(r.prompt)
        full = max(1, -(-(S + r.max_new_tokens) // bs))
        target = min(-(-(r.prefill_pos + self.chunk_tokens) // bs) + 1, full)
        grow = target - m.num_blocks
        if grow <= 0:
            return True
        gov = self.governor
        if gov is not None:
            if gov.defer_growth(r, grow, self.sched.queue):
                return False          # yield this step's headroom
            self._reserve_settle(r, lambda: gov.on_extend(r, grow))
        while True:
            try:
                self.cache.extend_sequence(m, grow,
                                           worker=self._worker_of(r))
                return True
            except Exception as e:
                if self._make_room(r):
                    continue
                if gov is not None:
                    raise CapacityError(
                        f"chunked prefill cannot grow request {r.rid} "
                        f"by {grow} blocks: pool exhausted and no "
                        "eviction or preemption victim remains") from e
                raise

    def _grow_for_decode(self, r: Request) -> bool:
        """Chunk-admitted mappings may not cover the next write block yet —
        grow one block ahead of the decode write, through the same
        governed extend path every chunk uses."""
        m = r.mapping
        j = (r.length - 1) // self.cache.block_size
        if j < m.num_blocks:
            return False
        grow = j + 1 - m.num_blocks
        self._reserve_settle(
            r, lambda: self.governor.on_extend(r, grow))
        while True:
            try:
                self.cache.extend_sequence(m, grow,
                                           worker=self._worker_of(r))
                return True
            except Exception as e:
                if self._make_room(r):
                    continue
                if self.governor is not None:
                    raise CapacityError(
                        f"decode cannot grow request {r.rid} by {grow} "
                        "blocks: pool exhausted and no eviction or "
                        "preemption victim remains") from e
                raise

    # -------------------------------------------------------- demand paging
    def _pager_fixpoint(self) -> bool:
        """Scan running windows to a resident fixpoint (bounded passes).

        Returns True when the final pass still faulted — i.e. the bound
        was hit without converging (over-committed pool).
        """
        faulted = False
        for _ in range(1 + len(self.sched.running)):
            faulted = False
            for slot, r in list(self.sched.running.items()):
                if self.sched.running.get(slot) is not r:
                    continue          # preempted by a mid-scan pressure fix
                m = r.mapping
                for idx in range(self._used_blocks(r)):
                    if m.physical[idx] < 0:
                        faulted = True
                        self._fault_in(r, idx)
            if not faulted:
                break
        return faulted

    def _fault_in(self, r: Request, idx: int) -> None:
        """touch() one block, evicting — or, under the governor,
        preempting a victim — until the allocation succeeds."""
        while True:
            try:
                self.cache.mgr.touch(r.mapping.mapping_id, idx,
                                     worker=self._worker_of(r))
                return
            except Exception:
                if not self._make_room(r):
                    raise

    def _outstanding_faults(self) -> bool:
        """Any non-resident block left in a running window?"""
        return any(r.mapping.physical[idx] < 0
                   for r in self.sched.running.values()
                   for idx in range(self._used_blocks(r)))

    def _relieve_pressure(self) -> None:
        """Governor give-up path: preempt victims until the pager converges.

        Replaces the legacy ``demand_pager_gave_up`` counter — decoding
        never proceeds with ``-1`` rows.  Raises :class:`CapacityError`
        when even a single running sequence cannot be made resident.
        """
        while True:
            victim = (self.governor.choose_victim(self.sched.running)
                      if len(self.sched.running) > 1 else None)
            if victim is None:
                raise CapacityError(
                    "demand pager cannot converge: running windows "
                    "over-commit the pool and no preemption victim remains")
            self._preempt(victim)
            self._pager_fixpoint()
            if not self._outstanding_faults():
                return

    def _settle_residency(self) -> None:
        """Run the pager to a resident fixpoint, escalating a give-up:
        legacy mode counts it (``demand_pager_gave_up``), the governed
        mode preempts victims until the pager converges.  Called once per
        step before any device work, and again after mid-step allocations
        (chunk/decode-boundary growth can evict an already-faulted
        block)."""
        if self._pager_fixpoint() and self._outstanding_faults():
            if self.governor is None:
                self.demand_pager_gave_up += 1
            else:
                self._relieve_pressure()

    # ----------------------------------------------------------------- step
    def step(self) -> int:
        """One engine iteration; returns tokens generated."""
        t0 = time.perf_counter()
        self._admit()
        if not self.sched.running:
            return 0
        self.evictor.maybe_evict()

        # demand paging: fault back any swapped-out block the step will
        # read (the paper's page-cache read path; triggers swap-in +
        # possibly more eviction).  The daemon is window-blind, so a fault
        # for one slot can evict an already-faulted block of an *earlier*
        # slot in the same pass — scan to a fixpoint (a pass that faults
        # nothing leaves every running window resident) so no SWAPPED row
        # ever reaches the decode tables.  An over-committed pool (running
        # windows simply don't fit) has no fixpoint; the pass bound keeps
        # the step from spinning.  Legacy mode counts the give-up
        # (demand_pager_gave_up) and ships -1 rows; under the governor the
        # give-up instead *preempts* victims until the pager converges
        # (raising CapacityError if no victim remains) — pressure becomes
        # preemption, never silent token divergence.
        self._settle_residency()
        if not self.sched.running:
            return 0

        # ragged serving: the whole mixed batch — chunk rows and decode
        # rows — goes through one fused-KV kernel call per layer
        if self._ragged:
            return self._ragged_pass(t0)

        # chunked prefill: at most one fixed-shape chunk per prefill-state
        # slot per step, interleaved with the decode below (a request
        # whose last chunk lands this step decodes this step).  Chunk and
        # decode-boundary growth allocate fresh blocks, which can evict an
        # already-faulted block of another slot — so the residency
        # fixpoint is restored afterwards, before the tables upload.
        if self._chunked:
            progressed = False
            for slot in sorted(self.sched.running):
                r = self.sched.running.get(slot)
                if r is None:
                    continue          # preempted by a mid-pass growth
                if r.state == "prefill":
                    self._prefill_chunk_step(r)
                    progressed = True
                elif r.state == "running":
                    progressed |= self._grow_for_decode(r)
            if progressed:
                self._settle_residency()
                if not self.sched.running:
                    return 0

        self._cow_pass()

        # decode covers only fully-prefilled slots; a mid-prefill slot is
        # excluded from the tables upload (its row reads -1, so the decode
        # kernel's write for it drops — never a corrupting write at
        # position 0 of a half-built sequence)
        decoders = {s: r for s, r in self.sched.running.items()
                    if r.state == "running"}
        if not decoders:
            # every occupied slot is still mid-prefill: the step did its
            # chunk work; decode resumes once a request promotes
            self.steps += 1
            self._finish_step(t0, 0)
            return 0

        # the incoming token is the last *known* token; it is (re)written at
        # its own position r.length−1 (idempotent for the prompt tail) and
        # the logits predict position r.length.
        lengths = np.zeros((self.cache.max_batch,), np.int32)
        tokens = np.zeros((self.cache.max_batch,), np.int32)
        for slot, r in decoders.items():
            lengths[slot] = r.length - 1
            tokens[slot] = (r.generated[-1] if r.generated
                            else r.prompt[-1])
        self.cache.update_tables(
            {s: r.mapping for s, r in decoders.items()}, lengths)

        logits, new_state = tfm.decode_step(
            self.params, self.cfg, dict(self.cache.state),
            self._tensor(tokens), page_impl=self.page_impl)
        self.cache.state = new_state
        self.decode_steps += 1
        lg = logits.cpu().numpy()

        made = 0
        for slot, r in list(decoders.items()):
            nxt = int(lg[slot].argmax())
            r.generated.append(nxt)
            made += 1
            if (len(r.generated) >= r.max_new_tokens
                    or (self.eos is not None and nxt == self.eos)):
                self.cache.free_sequence(r.mapping,
                                         worker=self._worker_of(r))
                r.mapping = None
                if self.governor is not None:
                    self.governor.on_release(r)
                self.sched.complete(r)
                if self.bus.wants(RequestCompleted):
                    self.bus.publish(RequestCompleted(
                        rid=r.rid, n_tokens=len(r.generated),
                        step=self.steps))
        self.steps += 1
        self.tokens_generated += made
        self._finish_step(t0, made)
        return made

    def _cow_pass(self) -> None:
        """Copy-on-write pass: the incoming token is (re)written at
        position r.length−1, so a sequence still pointing a *shared*
        block at that position must diverge onto a private copy first —
        before the tables upload ever shows the kernel a shared row it
        would write.  At most one copy per request (only a fully-shared
        block-aligned prompt leaves the write position shared); the copy
        grows the reservation by one block, the detached original stays
        in its sharing set (no fence)."""
        if not self.cache.prefix_sharing:
            return
        for r in list(self.sched.running.values()):
            if r.state != "running" or r.mapping is None:
                continue         # preempted by a mid-pass reservation grow
            j = (r.length - 1) // self.cache.block_size
            if (j < r.mapping.num_blocks
                    and self.cache.ensure_private(
                        r.mapping, j, worker=self._worker_of(r))):
                self._reserve_settle(
                    r, lambda: self.governor.on_extend(r, 1))

    def _ragged_pass(self, t0: float) -> int:
        """One ragged engine iteration: every slot's incoming tokens —
        prefill chunks and single-token decode rows alike — pack into one
        fixed-shape stream served by ONE ragged fused-KV kernel call per
        attention layer.  A request whose last chunk lands this step
        promotes in place: its chunk's last-token logits *are* the first
        decode logits (same position, same attended prefix), so it emits
        a token this very step, exactly like the per-slot chunk path.
        All descriptor shapes are static (``max_batch`` rows padded to
        the kernel's query-tile multiple), so the whole mixed step keeps
        the one-trace contract the chunk path pins."""
        from repro_torch.kernels.paged_attention.ops import build_ragged_descriptor

        # growth (chunk reservations + decode write blocks), then restore
        # the residency fixpoint, exactly like the per-slot chunk path
        chunkable: dict[int, Request] = {}
        progressed = False
        for slot in sorted(self.sched.running):
            r = self.sched.running.get(slot)
            if r is None:
                continue              # preempted by a mid-pass growth
            if r.state == "prefill":
                if self._grow_for_chunk(r):
                    chunkable[slot] = r
                    progressed = True
            elif r.state == "running":
                progressed |= self._grow_for_decode(r)
        if progressed:
            self._settle_residency()
            if not self.sched.running:
                return 0
        self._cow_pass()

        rows = []                     # (slot, request, start, end)
        for slot in sorted(self.sched.running):
            r = self.sched.running[slot]
            if r.state == "prefill":
                if chunkable.get(slot) is not r:
                    continue          # growth deferred this step
                start = r.prefill_pos
                end = min(len(r.prompt), start + self.chunk_tokens)
            elif r.state == "running":
                start, end = r.length - 1, r.length
            else:
                continue
            rows.append((slot, r, start, end))
        if not rows:
            self.steps += 1
            self._finish_step(t0, 0)
            return 0

        # tables upload covers every row's slot — chunk rows included,
        # since their scatters and page walks go through the same kernel
        lengths = np.zeros((self.cache.max_batch,), np.int32)
        for slot, r, start, end in rows:
            lengths[slot] = start
        self.cache.update_tables(
            {slot: r.mapping for slot, r, _, _ in rows}, lengths)

        d = build_ragged_descriptor(
            [slot for slot, *_ in rows],
            [end - start for _, _, start, end in rows],
            [start for _, _, start, _ in rows],
            [end for *_, end in rows],
            num_slots=self.cache.max_batch, t_cap=self._t_cap)
        flat = np.concatenate([
            np.asarray(r.prompt[start:end], np.int32)
            if r.state == "prefill"
            else np.asarray([r.generated[-1] if r.generated
                             else r.prompt[-1]], np.int32)
            for slot, r, start, end in rows])
        toks = np.zeros((self._t_cap,), np.int32)
        real = d["token_src"] >= 0
        toks[real] = flat[d["token_src"][real]]

        args = [self._tensor(a) for a in (
            toks, d["token_row"], d["token_pos"], d["tile_row"],
            d["tile_pos"], d["kv_lens"], d["last_index"])]
        st = dict(self.cache.state)
        self._chunk_sigs.add(("ragged",) + _signature([st, *args]))
        logits, new_state = tfm.ragged_step(self.params, self.cfg, st, *args,
                                            page_impl=self.page_impl)
        self.cache.state = new_state
        lg = logits.cpu().numpy()

        # host-side kernel accounting: one fused descriptor per resident
        # block per row per attention layer (the split layout would pay
        # two — see kernels/paged_attention/autotune.KernelCostModel)
        kvp = self.cache.state["kv"]
        block_bytes = int(np.prod(kvp.shape[2:])) * kvp.element_size()
        bs = self.cache.block_size
        n_layers = int(kvp.shape[0])
        self._ragged_steps += 1
        self._kernel_calls += n_layers
        self._kernel_dma_bytes += n_layers * block_bytes * sum(
            -(-end // bs) for *_, end in rows)

        made = 0
        for slot, r, start, end in rows:
            if r.state == "prefill":
                r.prefill_pos = end
                self.prefill_chunks += 1
                if self.bus.wants(PrefillChunkDone):
                    self.bus.publish(PrefillChunkDone(
                        rid=r.rid, start=start, end=end, step=self.steps))
                if end < len(r.prompt):
                    continue          # mid-prompt: no token this step
                r.state = "running"
            nxt = int(lg[slot].argmax())
            r.generated.append(nxt)
            made += 1
            if (len(r.generated) >= r.max_new_tokens
                    or (self.eos is not None and nxt == self.eos)):
                self.cache.free_sequence(r.mapping,
                                         worker=self._worker_of(r))
                r.mapping = None
                if self.governor is not None:
                    self.governor.on_release(r)
                self.sched.complete(r)
                if self.bus.wants(RequestCompleted):
                    self.bus.publish(RequestCompleted(
                        rid=r.rid, n_tokens=len(r.generated),
                        step=self.steps))
        self.steps += 1
        self.tokens_generated += made
        self._finish_step(t0, made)
        return made

    def _finish_step(self, t0: float, made: int) -> None:
        """Step epilogue: wall-time accounting, the step-latency
        histogram, and the :class:`StepCompleted` span event."""
        dt = time.perf_counter() - t0
        self.wall_s += dt
        self._hist_step.observe(dt, exemplar=f"step-{self.steps}")
        if self.bus.wants(StepCompleted):
            self.bus.publish(StepCompleted(step=self.steps, tokens=made,
                                           wall_s=dt,
                                           running=len(self.sched.running)))

    def run(self, max_steps: int = 10_000) -> dict:
        while not self.sched.idle and self.steps < max_steps:
            self.step()
        return self.metrics.snapshot()

    def _admission_metrics(self) -> dict:
        if self.governor is None:
            return {"enabled": False}
        return {"enabled": True, **self.governor.counters()}

    def _engine_metrics(self) -> dict:
        d = self._base_engine_metrics()
        if self._ragged:
            # KERNEL_SCHEMA group — present only on ragged engines, so
            # default snapshots stay bit for bit on the stable contract
            from repro_torch.kernels.paged_attention import autotune as pa_at
            tuned = pa_at.get_tuning(self.cfg.n_kv_heads,
                                     self.cfg.head_dim,
                                     self.cache.block_size)
            d["kernel"] = {
                "dma_bytes": self._kernel_dma_bytes,
                "kernel_calls": self._kernel_calls,
                "pipeline_depth": tuned.buffer_depth,
                "ragged_steps": self._ragged_steps,
            }
        return d

    def _base_engine_metrics(self) -> dict:
        return {
            "steps": self.steps,
            "obs": {"subscriber_errors": self.bus.subscriber_errors},
            "demand_pager_gave_up": self.demand_pager_gave_up,
            "num_workers": self.cache.num_workers,
            "tokens": self.tokens_generated,
            "wall_s": round(self.wall_s, 4),
            "tokens_per_s": round(
                self.tokens_generated / self.wall_s, 2)
            if self.wall_s else None,
            "completed": len(self.sched.done),
            "prefill_chunks": self.prefill_chunks,
            "prefill_traces": len(self._prefill_sigs),
            "prefill_chunk_traces": len(self._chunk_sigs),
        }
