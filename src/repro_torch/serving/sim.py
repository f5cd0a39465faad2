"""Worker-level simulation of fence impact — the paper's microbenchmark
harness (§V-A cases 1–5, §V-B eviction) at datacenter scale.

The paper measures how TLB shootdowns from I/O threads steal time from
compute threads.  The serving analogue: **alloc/free workers** (request
streams cycling KV blocks through mmap→access→munmap) steal time from
**compute workers** (decode/train steps) because a coherence fence drains
*every* worker's in-flight dispatch and stalls them for the fence cost.

Time is virtual (deterministic): each worker advances a clock; a fence at
time t adds ``fence_cost`` of stall to every worker whose clock overlaps
[t, t+fence_cost] — mirroring Fig. 3's lazy-shootdown asymmetry via the
``in_kernel_frac`` parameter (stalls while "in the kernel" are absorbed).

This is also the 1000+-node projection vehicle: the fence cost model
scales with replica count (log-tree table rebroadcast) and dispatch depth.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.config import FprConfig
from repro_torch.core.contexts import ContextScope, derive_context
from repro_torch.core.eviction import WatermarkEvictor, Watermarks
from repro_torch.core.fpr import FprMemoryManager
from repro_torch.core.shootdown import FenceCostModel, FenceEngine
from repro_torch.serving.admission import (CapacityError, GovernorConfig,
                                     MemoryGovernor)


@dataclass
class SimConfig:
    num_blocks: int = 4096
    io_workers: int = 1               # mmap-access-munmap cyclers
    compute_workers: int = 0          # pure compute (never allocate)
    mixed_workers: int = 0            # alternate I/O and compute
    iters: int = 2000                 # cycles per I/O(/mixed) worker
    blocks_per_map: int = 8           # mapping size (32 KiB-file analogue)
    alloc_cost: float = 1.0           # virtual µs per map+access+unmap
    compute_quantum: float = 1.0      # virtual µs per compute op
    compute_factor: float = 1.0       # CF knob (§V-B): quanta per I/O op
    in_kernel_frac: float = 0.0       # fraction of stalls absorbed (Fig. 3)
    fpr: bool = True
    scoped: bool = False              # worker-scoped fences (off ⇒ the
                                      # paper's global-broadcast pessimism)
    scope: ContextScope = ContextScope.PER_GROUP
    shared_context: bool = False      # all workers share one recycling ctx
    fence_cost: float = 25.0          # initiator wait per fence (virtual µs)
    recv_stall: float = 0.2           # per-recipient stall (remote flush +
                                      # TLB refill tail; calibrated to the
                                      # paper's ~21% compute loss shape)
    storage_latency: float = 0.0      # extra µs per map (device latency)
    shard_table_bytes: int = 64 << 10  # device block-table bytes per worker
                                       # shard (re-uploaded when a fence
                                       # covers that worker)
    refresh_bw: float = 40e3          # shard re-upload bandwidth, bytes per
                                      # virtual µs (PCIe/ICI-ish ratio vs
                                      # the 25 µs fence base cost)
    reshard_iters: tuple = ()         # ((iteration, new_num_workers), …):
                                      # elastic topology changes applied
                                      # mid-run; each costs the *moved*
                                      # row fraction of the full table
                                      # (see device_refreshed_bytes),
                                      # never a cold re-upload
    islands: tuple = ()               # island partition of ALL workers
                                      # (io + mixed + compute) for the
                                      # two-level fence engine; () ⇒ flat.
                                      # Cross-island fences pay the cost
                                      # model's cross_island_cost multiple
                                      # of fence_cost (remote delta
                                      # propagation)
    seed: int = 0


@dataclass
class SimResult:
    io_ops: int = 0
    compute_ops: int = 0
    fences: int = 0
    fences_skipped: int = 0
    elided: int = 0
    io_time: float = 0.0
    compute_time: float = 0.0
    stall_time: float = 0.0
    evictions: int = 0
    device_refreshed_bytes: int = 0   # Σ shard bytes re-uploaded by fences
    refresh_time: float = 0.0         # virtual µs spent re-uploading shards
    reshards: int = 0                 # elastic topology changes applied
    reshard_moved_rows: int = 0       # table rows whose shard owner moved

    def throughput(self) -> float:
        t = max(self.io_time, 1e-9)
        return self.io_ops / t

    def compute_throughput(self) -> float:
        t = max(self.compute_time, 1e-9)
        return self.compute_ops / t

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["io_throughput"] = self.throughput()
        d["compute_throughput"] = self.compute_throughput()
        return d


class FenceImpactSim:
    """Deterministic virtual-time simulation of cases 1–5."""

    def __init__(self, cfg: SimConfig,
                 cost_model: FenceCostModel | None = None):
        self.cfg = cfg
        self.fences = FenceEngine(cost_model=cost_model, measure=False,
                                  scoped=cfg.scoped)
        self.mgr = FprMemoryManager(
            config=FprConfig(
                num_blocks=cfg.num_blocks,
                num_workers=max(1, cfg.io_workers + cfg.mixed_workers),
                fpr_enabled=cfg.fpr, scoped_fences=cfg.scoped),
            fence_engine=self.fences)
        # compute workers hold table replicas too (they are what a global
        # fence needlessly stalls); give them epoch slots after io+mixed
        total = max(1, cfg.io_workers + cfg.mixed_workers
                    + cfg.compute_workers)
        self.fences.ensure_workers(total)
        if cfg.islands:
            # the partition covers *all* workers (compute included), so it
            # is installed on each layer directly rather than through
            # mgr.set_topology (which validates against the manager's
            # io+mixed worker count)
            from repro_torch.core.topology import Topology
            topo = Topology.of(cfg.islands, num_workers=total)
            if not topo.is_flat:
                self.mgr.tracker.set_topology(topo)
                self.fences.set_topology(topo)
                self.mgr.tables.set_topology(topo)
        self.res = SimResult()

    def run(self) -> SimResult:
        c = self.cfg
        res = self.res
        n_io = c.io_workers
        n_cp = c.compute_workers
        n_mx = c.mixed_workers

        def fence_stall(covered, cross=False):
            # every worker the fence covered is stalled for recv_stall
            # (remote flush + refills); the initiating worker waits
            # fence_cost for all confirmations (grows weakly with
            # recipient count — tree-ack).  A global fence covers every
            # worker; a scoped fence only its mask's popcount —
            # that difference is exactly the paper's observation that the
            # OS stalls cores that never cached the translation.
            # On top of the wait, each covered worker's device block-table
            # shard must be re-uploaded (shard_table_bytes / refresh_bw per
            # shard) — the per-shard device-refresh cost of the fence.
            absorbed = c.in_kernel_frac
            per_worker = c.recv_stall * (1.0 - absorbed)
            res.stall_time += per_worker * covered
            refreshed = covered * c.shard_table_bytes
            res.device_refreshed_bytes += refreshed
            refresh = refreshed / c.refresh_bw
            res.refresh_time += refresh
            import math
            base = c.fence_cost * (1 + 0.15 * math.log2(max(2, covered)))
            if cross:
                # the fence's scope spans islands: the initiator also waits
                # for remote-island delta propagation (the two-level
                # engine's configurable multiplier)
                base *= self.fences.cost_model.cross_island_cost
            return base + refresh

        fences_before = self.fences.stats.fences

        def io_op(wid, ctx_gid):
            wid %= self.mgr.num_workers       # topology may have shrunk
            ctx = (derive_context(c.scope, group_id=ctx_gid)
                   if c.fpr else None)
            st = self.fences.stats
            isl = self.fences.island_stats
            f0, w0 = st.fences, st.workers_covered
            x0 = isl.fences_cross if isl is not None else 0
            m = self.mgr.mmap(c.blocks_per_map, ctx, worker=wid)
            self.mgr.munmap(m.mapping_id, worker=wid)
            res.io_ops += 1
            cost = c.alloc_cost + c.storage_latency
            if st.fences > f0:
                cross = isl is not None and isl.fences_cross > x0
                cost += fence_stall(st.workers_covered - w0, cross)
            res.io_time += cost

        def reshard(new_workers):
            # per-shard refresh cost model, applied to the topology event
            # itself: only the moved row fraction of the full device table
            # is re-broadcast (a cold start would pay the whole table)
            old_workers = self.mgr.num_workers
            plan = self.mgr.reshard(new_workers)
            moved = len(plan["moved_slots"])
            frac = moved / max(1, self.mgr.tables.max_seqs)
            refreshed = int(frac * old_workers * c.shard_table_bytes)
            res.reshards += 1
            res.reshard_moved_rows += moved
            res.device_refreshed_bytes += refreshed
            refresh = refreshed / c.refresh_bw
            res.refresh_time += refresh
            res.io_time += refresh            # the initiator waits

        reshard_at = dict(c.reshard_iters)

        for it in range(c.iters):
            if it in reshard_at:
                reshard(reshard_at[it])
            # --- I/O workers: mmap → access → munmap ----------------------
            for w in range(n_io):
                io_op(w, 1 if c.shared_context else (w + 1))
            # --- compute workers: stalled only by fences ------------------
            if n_cp:
                res.compute_ops += n_cp
                res.compute_time += n_cp * c.compute_quantum
            # --- mixed workers: alternate -------------------------------
            for w in range(n_mx):
                io_op(n_io + w, 1 if c.shared_context else (100 + w))
                res.compute_ops += int(c.compute_factor)
                res.compute_time += c.compute_factor * c.compute_quantum

        st = self.fences.stats
        res.fences = st.fences - fences_before
        res.fences_skipped = st.skipped_at_free
        res.elided = st.elided_by_version
        isl = self.fences.island_stats
        if isl is not None:
            # attached only under a multi-island topology so flat-run
            # as_dict() keeps its pre-island key set bit for bit
            res.fences_intra = isl.fences_intra
            res.fences_cross = isl.fences_cross
            res.deltas_propagated = isl.deltas_propagated
        # compute workers absorb the accumulated stall into their time
        if n_cp or n_mx:
            res.compute_time += res.stall_time
        return res


def eviction_sim(cfg: SimConfig, *, working_set_factor: float = 10.0,
                 pg_buffer: int = 0,
                 watermarks: Watermarks | None = None) -> SimResult:
    """§V-B: threads randomly touch a mapping ≫ memory; kswapd evicts.

    ``pg_buffer`` models the per-thread local memory (PG) — each compute
    quantum touches it, and every fence's TLB flush forces page-walk
    refills proportional to the buffer size (the paper's PG effect).
    """
    rng = np.random.default_rng(cfg.seed)
    fences = FenceEngine(measure=False)
    mgr = FprMemoryManager(
        config=FprConfig(num_blocks=cfg.num_blocks, num_workers=1,
                         fpr_enabled=cfg.fpr,
                         max_blocks_per_seq=int(
                             cfg.num_blocks * working_set_factor) + 1),
        fence_engine=fences)
    res = SimResult()
    n_threads = max(1, cfg.mixed_workers)
    total_blocks = int(cfg.num_blocks * working_set_factor)
    ctx = derive_context(cfg.scope, group_id=1) if cfg.fpr else None
    m = mgr.mmap_sparse(total_blocks, ctx)

    victims_state = {"pos": 0}

    def victims():
        # LRU ring over the big mapping
        start = victims_state["pos"]
        for i in range(total_blocks):
            idx = (start + i) % total_blocks
            victims_state["pos"] = (idx + 1) % total_blocks
            yield m.mapping_id, idx, cfg.fpr

    ev = WatermarkEvictor(mgr, victims, watermarks=watermarks)

    for it in range(cfg.iters):
        for t in range(n_threads):
            idx = int(rng.integers(0, total_blocks))
            f0 = fences.stats.fences
            ev.maybe_evict()
            _, faulted = mgr.touch(m.mapping_id, idx)
            res.io_ops += 1
            cost = cfg.alloc_cost + (cfg.storage_latency if faulted else 0)
            fences_recv = fences.stats.fences - f0
            if fences_recv:
                stall = cfg.fence_cost * (1 - cfg.in_kernel_frac)
                stall += cfg.recv_stall * (n_threads - 1) * fences_recv
                # TLB refill for the PG buffer after each flush
                stall += pg_buffer * 0.05 * fences_recv
                # single-worker sim: every fence re-uploads one table shard
                refreshed = fences_recv * cfg.shard_table_bytes
                res.device_refreshed_bytes += refreshed
                res.refresh_time += refreshed / cfg.refresh_bw
                stall += refreshed / cfg.refresh_bw
                cost += stall
                res.stall_time += stall
            res.io_time += cost
            res.compute_ops += int(cfg.compute_factor)
            res.compute_time += cfg.compute_factor * cfg.compute_quantum
    res.compute_time += res.stall_time
    res.fences = fences.stats.fences
    res.fences_skipped = fences.stats.skipped_at_free
    res.elided = fences.stats.elided_by_version
    res.evictions = ev.stats.blocks_evicted
    return res


# ===================================================================== admission
@dataclass
class AdmissionSimConfig:
    """Virtual-time model of the admission/preemption subsystem.

    ``n_requests`` jobs drain through ``max_batch`` decode slots over a
    ``pool_blocks`` ledger (block_size 1: a job's window *is* its block
    count).  ``arrival_every = 0`` queues everything at t=0 (closed loop);
    ``> 0`` staggers arrivals by that many virtual steps — the open-loop
    shape where FCFS first-fit *starves* large windows (freshly freed
    capacity is re-nibbled by small late arrivals before a large window
    can accumulate) and the SLA/deadline policy's capacity holds bound the
    tail.  Each virtual step every running job decodes once;
    admission-queue latency is the steps a job spends queued after
    arriving.  With ``overcommit_ratio > 1`` the ledger admits
    optimistically and demand-pager pressure (committed > pool) preempts
    victims — ``recompute`` forfeits the victim's decoded progress plus a
    re-prefill, ``swap`` pays per-block transfer both ways but keeps
    progress — the same cost split the real engine's two victim strategies
    have.
    """

    pool_blocks: int = 64
    max_batch: int = 8
    n_requests: int = 64
    n_streams: int = 4
    priority_classes: int = 1          # >1 ⇒ jobs get seeded priorities
    policy: str = "fcfs"               # fcfs | recycle | priority | deadline
    preempt: str = "recompute"         # recompute | swap
    overcommit_ratio: float = 1.0
    window_lo: int = 2                 # job window, blocks (seeded uniform)
    window_hi: int = 8
    large_frac: float = 0.0            # >0 ⇒ bimodal mice-and-elephants mix:
                                       # window_hi with this probability,
                                       # else window_lo (the classic
                                       # first-fit starvation workload)
    steps_per_block: int = 4           # decode steps per window block
    step_time: float = 1.0             # virtual µs per engine step
    prefill_cost: float = 4.0          # virtual µs per (re-)prefill
    swap_cost_per_block: float = 0.5   # virtual µs per block swapped out+in
    sla_steps: float = 64.0            # deadline budget (virtual steps) for
                                       # the SLA-aware deadline policy
    arrival_every: float = 0.0         # virtual steps between arrivals
                                       # (0 ⇒ closed loop, all at t=0)
    chunk_blocks: int = 0              # >0 ⇒ chunked-prefill admission: a
                                       # job is admitted on its first chunk
                                       # (+1 tail block) and the ledger
                                       # reservation grows one chunk per
                                       # step — elephants take capacity
                                       # gradually instead of blocking the
                                       # whole window at admission, which
                                       # is what bounds mice queue-wait.
                                       # 0 ⇒ monolithic full-window admits.
    num_workers: int = 1               # ledger shares (per-worker splits)
    reshard_iters: tuple = ()          # ((step, new_num_workers), …):
                                       # mid-run topology changes; the
                                       # governor's reshard remaps ledger
                                       # shares, and reshard-aware policies
                                       # see the upcoming distance
                                       # (note_reshard_distance) to defer
                                       # elephant chunk growth across it
    seed: int = 0


@dataclass
class _SimJob:
    rid: int
    stream: str
    priority: int
    window: int
    service_steps: int
    arrival: int = 0                   # virtual arrival ordinal (EDF key)
    sla: "float | None" = None         # deadline budget (deadline policy)
    prompt: range = range(0)           # governor reads len(prompt)+max_new
    max_new_tokens: int = 0
    done_steps: int = 0
    wait_steps: int = 0
    swapped: bool = False
    mapping: "object | None" = None    # swap-preempted holder: admit_blocks
                                       # must re-reserve the held blocks,
                                       # never a fresh chunk estimate

    def __post_init__(self) -> None:
        self.prompt = range(self.window)     # block_size 1 ⇒ window blocks


@dataclass
class _HeldBlocks:
    """What a swap-preempted sim job still holds (mapping stand-in)."""

    num_blocks: int
    prefix_hits: int = 0


def admission_sim(cfg: AdmissionSimConfig) -> dict:
    """Deterministic admission/preemption sweep point (virtual time)."""
    rng = np.random.default_rng(cfg.seed)
    gov = MemoryGovernor(
        cfg.pool_blocks, block_size=1, num_workers=cfg.num_workers,
        config=GovernorConfig(policy=cfg.policy, preempt=cfg.preempt,
                              overcommit_ratio=cfg.overcommit_ratio))
    gov.chunk_blocks = cfg.chunk_blocks or None
    jobs = []
    for i in range(cfg.n_requests):
        if cfg.large_frac > 0:
            w = (cfg.window_hi if rng.random() < cfg.large_frac
                 else cfg.window_lo)
        else:
            w = int(rng.integers(cfg.window_lo, cfg.window_hi + 1))
        jobs.append(_SimJob(
            rid=i + 1, stream=f"s{i % cfg.n_streams}",
            priority=int(rng.integers(0, max(1, cfg.priority_classes))),
            window=w, service_steps=w * cfg.steps_per_block,
            arrival=int(i * cfg.arrival_every) + 1 if cfg.arrival_every
            else i + 1, sla=cfg.sla_steps))
    if cfg.arrival_every:
        pending = list(jobs)            # arrive over virtual time
        queue: list[_SimJob] = []
    else:
        pending = []
        queue = list(jobs)              # closed loop: all queued at t=0
    running: dict[int, _SimJob] = {}
    done: list[_SimJob] = []
    overhead = 0.0                      # prefill + swap virtual time
    wasted_steps = 0                    # decode work forfeited by recompute
    steps = 0

    def preempt(victim: _SimJob) -> None:
        nonlocal overhead, wasted_steps
        slot = next(s for s, j in running.items() if j is victim)
        held = (gov.ledger.entries[victim.rid].blocks
                if gov.ledger.holds(victim.rid) else victim.window)
        del running[slot]
        gov.on_release(victim)
        if cfg.preempt == "swap":
            overhead += held * cfg.swap_cost_per_block
            victim.swapped = True
            # re-admission must re-reserve exactly what the victim still
            # holds (its blocks fault back in full), not a chunk estimate
            victim.mapping = _HeldBlocks(held)
        else:
            wasted_steps += victim.done_steps
            victim.done_steps = 0      # chunked growth restarts from 0 too
            victim.mapping = None
        gov.count_preempt(cfg.preempt)
        queue.insert(0, victim)

    def grow(job: _SimJob, n: int) -> bool:
        """Grow ``job``'s reservation by ``n`` blocks; False = the chunk
        stalls this step.  The sim's growth *waits* for freed capacity
        rather than preempting seated jobs — evicting a seated mouse to
        grow an elephant would invert every ordering the policies encode
        (the real engine escalates through its evictor first, which the
        block-ledger sim has no analogue for)."""
        try:
            gov.on_extend(job, n)
            return True
        except CapacityError:
            return False

    reshard_at = dict(cfg.reshard_iters)
    workers = cfg.num_workers
    reshards = 0

    while pending or queue or running:
        steps += 1
        if steps > 1_000_000:
            raise RuntimeError("admission_sim failed to drain — "
                               "a job can never be admitted")
        while pending and pending[0].arrival <= steps:
            queue.append(pending.pop(0))
        # --- elastic topology: remap ledger shares, advertise distance ---
        if steps in reshard_at:
            new_w = reshard_at[steps]
            gov.reshard(new_w, [w % new_w for w in range(workers)])
            workers = new_w
            reshards += 1
        upcoming = [s for s in reshard_at if s > steps]
        gov.note_reshard_distance(
            min(upcoming) - steps if upcoming else None)
        # --- priority pressure: evict lower classes for a blocked one ----
        while True:
            bi = gov.wants_priority_preempt(queue)
            if bi is None:
                break
            victim = gov.choose_victim(
                running, below_priority=queue[bi].priority)
            if victim is None:
                break
            preempt(victim)
        # --- chunked growth: reservations track written blocks -----------
        # A chunk-admitted job holds only what it has written plus
        # ``chunk_blocks + 1`` of headroom; its service fills one window
        # block per ``steps_per_block``, so elephants take capacity
        # gradually across their whole service instead of locking the
        # full window at admission (what starves mice monolithically).
        # Growers run *before* admission: freed capacity reaches a
        # partially-grown sequence ahead of the queue by default, and it
        # is the policy's defer_growth that explicitly yields a step's
        # headroom to a more urgent queued mouse (or parks growth across
        # an imminent reshard) — ranking growers vs mice is policy, not
        # loop order.
        if cfg.chunk_blocks:
            def can_write(j: _SimJob) -> bool:
                held_j = gov.ledger.entries[j.rid].blocks
                return j.done_steps < held_j * cfg.steps_per_block
            for slot, job in list(running.items()):
                if running.get(slot) is not job:
                    continue
                held = gov.ledger.entries[job.rid].blocks
                target = min(job.done_steps // cfg.steps_per_block
                             + cfg.chunk_blocks + 1, job.window)
                n = target - held
                if n <= 0:
                    continue
                if gov.defer_growth(job, n, queue):
                    continue           # policy yields the step's headroom
                while not grow(job, n):
                    # a stalled growth normally just waits for a decoder
                    # to release capacity — but when *every* runner is a
                    # stalled grower nothing will ever release, and the
                    # pool deadlocks; escalate to preemption (the
                    # engine's evict→preempt ladder) to keep it live
                    if any(j is not job and can_write(j)
                           for j in running.values()):
                        break
                    victim = (gov.choose_victim(running,
                                                exclude=(job.rid,))
                              if len(running) > 1 else None)
                    if victim is None:
                        break
                    preempt(victim)
        # --- admission (policy order, ledger-checked) --------------------
        while len(running) < cfg.max_batch:
            idx = gov.select(queue)
            if idx is None:
                break
            job = queue.pop(idx)
            slot = next(s for s in range(cfg.max_batch) if s not in running)
            running[slot] = job
            gov.on_admit(job, slot)
            job.mapping = None  # reservation re-seated; holder consumed
            if job.swapped:     # fault-back; out+in paid at preempt time
                job.swapped = False
            else:
                overhead += cfg.prefill_cost
        # --- pager pressure: over-committed ⇒ preempt (vLLM give-up fix) -
        while gov.ledger.committed > cfg.pool_blocks and len(running) > 1:
            victim = gov.choose_victim(running)
            if victim is None:
                break
            preempt(victim)
        # --- decode + queue latency -------------------------------------
        for slot, job in list(running.items()):
            if (cfg.chunk_blocks and job.done_steps
                    >= gov.ledger.entries[job.rid].blocks
                    * cfg.steps_per_block):
                continue           # out of reserved blocks — stalled grower
            job.done_steps += 1
            if job.done_steps >= job.service_steps:
                del running[slot]
                gov.on_release(job)
                done.append(job)
        for job in queue:
            job.wait_steps += 1

    waits = [j.wait_steps * cfg.step_time for j in jobs]
    # mice = the small-window class of the bimodal mix (everyone, when the
    # workload is unimodal) — their tail is what chunked admission and the
    # deadline policy's holds are protecting
    mice = ([j for j in jobs if j.window == cfg.window_lo]
            if cfg.large_frac > 0 else jobs)
    mice_waits = ([j.wait_steps * cfg.step_time for j in mice] or [0.0])
    g = gov.stats
    return {
        "policy": cfg.policy, "preempt": cfg.preempt,
        "overcommit_ratio": cfg.overcommit_ratio,
        "chunk_blocks": cfg.chunk_blocks,
        "completed": len(done),
        "makespan": steps * cfg.step_time,
        "queue_wait_mean": round(float(np.mean(waits)), 3),
        "queue_wait_p99": round(float(np.percentile(waits, 99)), 3),
        "queue_wait_max": round(float(np.max(waits)), 3),
        "queue_wait_mean_mice": round(float(np.mean(mice_waits)), 3),
        "queue_wait_p99_mice": round(float(np.percentile(mice_waits, 99)),
                                     3),
        "chunk_grows": g.chunk_grows,
        "reshards": reshards,
        "preemptions_recompute": g.preemptions_recompute,
        "preemptions_swap": g.preemptions_swap,
        "rejected_overcommit": g.rejected_overcommit,
        "holds": g.holds,
        "affinity_hit_rate": g.affinity_hit_rate,
        "wasted_decode_steps": wasted_steps,
        "preempt_overhead": round(overhead, 3),
        "peak_committed": gov.ledger.peak_committed,
        "pool_blocks": cfg.pool_blocks,
    }
