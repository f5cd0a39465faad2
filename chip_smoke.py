#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the FPR serving path, the
full-sequence forward of the hybrid families, the encoder-decoder and
vision-prefix families, training, serving and training on a device mesh,
and the multi-pod dry run.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, any
of which fails the script:

1. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with nvcc,
   one nvcc process per source, all at once;
2. hold each kernel against its plain PyTorch version on the card:
   - at granite-3-8b attention shapes (KV=8, G=4, hd=128, bs=128, B=8,
     M=32) the paged decode kernel fused at depths 1, 2 and 4 (asserted
     bit-identical) and over split pools, with W in {1, 4}, holes and a
     sliding window; the ragged kernel on a mixed batch of unaligned
     prefill rows and decode rows; then both in the three (q, pool) pairs
     of element types other than (f32, f32) (q f32 over a bf16 pool, both
     bf16, q bf16 over an f32 pool): each output has q's dtype and equals
     the f32 kernel on the upcast inputs rounded to it, bit for bit, at
     every depth and over split pools, and is within one bf16 ulp (bf16
     output) or 2e-5 (f32 output) of its plain version at the same dtypes;
     the sha256 of each f32 output on seeded cases (granite's heads, hd
     64 and 120 decode, the ragged kernel split-K at hd 64, 96 and 128)
     is printed (compare a parent's with ``tools/paged_f32_hashes.py``),
     and the decode variants and the ragged kernel are timed again with q
     and pool in bf16 (``bf16_*`` fields of rows 1-4; their bound counts
     the TF32 passes bf16 inputs need for exact f32 sums, 1 for Q.K^T
     and 2 for P.V, and ``bf16_bound_bf16tc_ms`` the bf16 tensor-core
     peak);
   - flash attention at Jamba's attention widths (causal, S=4096, H=32,
     KV=8, hd=128) and h2o-danube-3-4b's (window 4096, S=6144, hd=120),
     then in the three (q, k/v) pairs of f32 and bf16: each output has q's
     dtype and equals the f32 kernel on the upcast inputs rounded to it,
     bit for bit, and is within one bf16 ulp (bf16 output) or 2e-5 x
     max(1, max|want|) (f32 output) of its plain version; timed again
     with q, k and v in bf16 (``bf16_*`` fields of row 5);
   - at DeepSeek-V2 shapes (H=128, rank=512, rope=64, bs=128, B=8, M=16)
     the absorbed-MLA paged decode kernel, with W in {1, 4}, holes and a
     slot of length 0, then in the three (queries, pools) pairs: the f32
     context equals the f32 kernel on the upcast inputs, bit for bit;
     timed again in the decode path's pair, f32 queries over bf16 pools
     (``bf16_*`` fields of row 6, whose bound counts 2 TF32 passes for
     Q.K^T, one operand being f32, and 2 for P.V); the f32 hashes also
     cover flash (Jamba, danube, hd 36) and MLA (W 1 and 4);
   - the Mamba selective scan at Jamba's widths (B=2, S=2000, DI=8192,
     N=16; B and C column views of the x_proj output, as the model makes
     them) and the RWKV-6 WKV scan at RWKV-6-7B's (B=2, S=2000, 64 heads
     of 64), nonzero initial states; the RWKV-6 scan also with strong
     decays on half the heads (log w down to -5), whose chunks take the
     kernel's sequential path;
   - the paged decode kernel at whisper-small's heads (12 KV heads of 64,
     one query head each) and InternVL2-26B's (8 KV heads of 128, G 6),
     and the ragged kernel at InternVL2's, on a mixed batch.
   Each kernel is timed with CUDA events beside its bound, its plain
   version and, for the attention kernels, one PyTorch library call (SDPA,
   a yardstick the port never calls); ``ms`` is one eager call.  Every
   kernel is also timed as one replay of a CUDA graph of the call
   (``graph_ms``, the device time of its launches); the kernels on the
   tensor cores give their 3xTF32 bound beside the f32 one, the Mamba
   scan its ex2 floor beside the bytes, the split-K kernels their
   geometry and scratch, and the flash, Mamba and RWKV-6 rows their op's
   time (``op_ms``, on the model's layout) beside the kernel's;
3. tune the paged decode kernel's buffer depth with CUDA events
   (``autotune``) for each (KV heads, head_dim, bs) the script serves:
   granite-3-8b, Jamba and InternVL2 share (8, 128, 128), tuned at
   granite's engine decode shape (B 8, G 4, 20 blocks a sequence) over an
   f32 and over a bf16 pool, and whisper-small's (12, 64, 128) at its own
   (B 2, G 1, 2 blocks); it prints each depth's ms and the winner, and
   every later phase decodes at the depth recorded for its pool's dtype;
4. serve granite-3-8b at full width and depth (random f32 weights from a
   seeded generator) through the chunked path (decode through the paged
   decode kernel) and the ragged path (ragged kernel), each against the
   same engine with ``page_impl="ref"`` as the token oracle: the kernel
   run is forced to the oracle's tokens and its own greedy token must be
   the oracle's at every position but at a near-tie (margin < 1e-3), and
   the kernels' launch counts on those runs are checked (and the stream
   time their calls spanned printed); then the same in bf16 (bf16
   weights, ``EngineConfig(dtype=bfloat16)``) under the bf16 near-tie
   rule (oracle top-2 margin at most 3e-2 x max(1, |top logit|)),
   tokens/s printed beside the f32 runs'; then granite cut to 8 layers
   with f32 weights (f32 queries and logits) over a bf16 pool, chunked
   path, under the f32 rule;
5. serve DeepSeek-V2 at its published widths, cut to 4 layers (layer 0
   dense, 1-3 MoE; random weights), through monolithic prefill and paged
   MLA decode (the MLA kernel) against ``page_impl="ref"``, the kernel
   run teacher-forced (the oracle runs first): in f32 under the f32
   near-tie rule, then with bf16 weights over a bf16 latent pool
   (``EngineConfig(dtype=bfloat16)``; the queries stay f32) under the
   bf16 rule; check the MLA kernel ran once per layer per decode step in
   each, and print tokens/s and the stream time its calls spanned;
6. Jamba-v0.1 at its published widths cut to one 8-layer period, then
   RWKV-6-7B whole (random f32 weights): ``prefill(impl="kernel")`` of 2
   prompts of 1000 tokens and 16 greedy ``decode_step``s against the
   ``impl="chunked"``/``page_impl="ref"`` oracle, ``loss_fn(impl=
   "kernel")`` on a (2, 1024) batch against ``impl="chunked"``, and for
   Jamba ``attn_layer(impl="kernel")`` (flash attention) on its attention
   layer; each path's launches are counted on their own, and the stream
   time the scan op's calls spanned in prefill and in ``loss_fn`` is
   printed; Jamba's attention layer again with bf16 weights and input,
   and h2o-danube-3-4b's layer 0 at its widths in bf16 on (1, 6144,
   3840) (window 4096, hd 120), each ``attn_layer(impl="kernel")`` (one
   flash launch) within 3e-2 x max(1, max|want|) of ``impl="chunked"``;
7. whisper-small whole (12 decoder + 12 encoder layers over 1500 frames;
   random f32 weights and frames): ``prefill(enc_frames=...)`` of 2
   prompts of 200 tokens and 16 greedy ``decode_step``s through the paged
   decode kernel against ``page_impl="ref"`` (exactly 12 x 16 launches,
   no other kernel), and ``loss_fn`` with frames on (2, 448),
   ``impl="chunked"`` against ``"direct"``;
8. InternVL2-26B at its published widths cut to 16 of 48 layers:
   ``prefill(patches=...)`` of a 256-token vision prefix plus 2 prompts of
   300 tokens and 16 greedy decode steps against the oracle, ``loss_fn``
   with patches, chunked against direct, and text traffic through the
   engine's ragged path against the same engine over ``page_impl="ref"``
   (the ragged kernel once per layer per ragged step);
9. train granite-3-8b at its published widths cut to 8 of 40 layers
   (random f32 weights, ``SyntheticLM`` batches of (2, 1024)) from the
   same params and fresh AdamW state three ways: (a) ``TrainConfig(
   attn_impl="chunked", remat=True)`` for 3 steps (the chunked
   attention's recompute backward and checkpointed blocks), (b)
   ``attn_impl="direct", remat=False`` for 3 steps (plain autograd
   through the O(S²) oracle), (c) (a) with 2 microbatches for 1 step;
   (a)'s step-0 loss equals ``loss_fn``'s forward within 1e-6, (a) and
   (b) agree within 1e-4 in loss and grad norm at every step, (c) equals
   (a)'s first step within 1e-5, (a)'s peak memory is below (b)'s, and no
   kernel launches; prints seconds per step, tokens/s and both peaks;
10. serve on a device mesh: two processes on the one GPU, joined over
   gloo (NCCL refuses two ranks on one GPU) through a file store, each
   one rank of a (data 1, model 2) mesh of CUDA tensors: (a) the
   sequence-parallel paged decode (every table column, "sp", and the
   rank's own, "sp_opt") at granite-3-8b's attention widths over 8
   sequences of 300-2500 tokens, and the SP absorbed-MLA context at
   DeepSeek-V2's widths, against the single-device kernels and their
   plain versions (2e-5), with each rank's ms per call; (b) granite-3-8b
   at its published widths cut to 4 layers, ``prefill(mesh=)`` of 2 x
   1000 tokens and 16 greedy ``decode_step(page_impl="sp")`` steps, whose
   tokens must equal the single-process ``page_impl="ref"`` oracle run
   here first (but at near-ties) on both ranks, launching no kernel; (c)
   DeepSeek-MoE-16B at its published widths cut to 4 layers (layer 0
   dense, 1-3 MoE: 64 routed experts of 1408, top-6, 2 shared; 2.3 B
   params, 9.1 GB f32) the same way, its MoE layers expert-parallel:
   each rank keeps its 32 experts a layer and its shared-expert blocks
   (``sharding.expert_shards``, the whole stacks dropped), and prints the
   expert bytes it holds and its resident memory beside the whole
   model's and its ms per decode step; tokens against the oracle, run
   and freed first; (d) serving from the rank's ``param_specs`` blocks
   (``sharding.shard_params``, the whole params dropped) through a
   ``Layout``, each rank its batch rows: (b)'s granite on (data 2,
   model 1) and (data 1, model 2), tokens equal to (b)'s oracle, each
   rank's resident memory before prefill, less the leaves
   ``param_specs`` keeps whole on the mesh (on (2, 1) the tied
   embedding), at most 0.55 of the leaves it splits; then RWKV-6-7B cut
   to 2 layers, DeepSeek-V2 cut to layer 0 and Jamba cut to layer 0 on
   (1, 2), each mixer computing its half of the heads or channels:
   ``prefill(impl="kernel")`` of 2 x 1000 (the scan kernels on the
   rank's shapes: RWKV-6 2 launches a rank, Jamba 1) and 16
   ``decode_step(page_impl="sp")`` steps against a one-process
   ``impl="chunked"``/``page_impl="ref"`` oracle run and freed first;
   each run prints the rank's resident GB beside the whole model's,
   prefill seconds, decode tokens/s and the collectives' calls and GB
   of the prefill and of a decode step.  A failing rank fails the
   script;
11. train on a device mesh: two processes on the one GPU over gloo, as in
   phase 10 (``--train-rank R``, files under ``build/train_mesh_phase/``).
   Each first probes gloo's collectives on CUDA tensors
   (``repro_torch.distributed.probe``: which work, and the seconds of
   ``all_reduce``, ``all_gather_into_tensor`` and ``broadcast`` at 64 MB,
   256 MB and 1 GB), then trains phase 9's model from (a)'s params and
   batches for 2 steps with ``make_train_step(cfg, tc, mesh)`` on a (data
   2, model 1) mesh (FSDP) and a (data 1, model 2) mesh (tensor parallel,
   the vocab-parallel loss over the tied table): loss and grad norm at
   each step and each leaf's sum of squares after them within 1e-5
   relative of (a)'s, and on the FSDP mesh each rank's resident state
   before the first step at most 0.55 of (a)'s; it prints seconds per
   step, tokens/s, resident and peak memory, and the collectives' calls,
   bytes and seconds per step; then phase 10 (c)'s model trained the
   same way on (data 1, model 2) with its MoE layers expert-parallel,
   held to 1e-5 of the same step in one process (run and freed here
   first: its params, gradients and moments are about 36 GB); (d) the
   tensor-parallel mixers on (data 1, model 2), each rank computing half
   of the heads or channels: RWKV-6-7B cut to 2 layers (1.06 B params),
   DeepSeek-V2 cut to layer 0 (MLA and the dense FFN of 12288; 1.39 B)
   and Jamba cut to layer 0 (Mamba and a dense FFN; 0.82 B) at their
   published widths, 2 steps of (2, 1024) each, held to 1e-5 of the same
   step in one process (each run and freed first).  Then
   ``pipeline_apply`` over the two ranks (one granite-3-8b layer a
   stage, 4 microbatches of (1, 1024, 4096)) within 1e-5 of the layers
   applied in sequence here.  No kernel launches (the kernels are
   forward only).  A failing rank fails the script;
   10 (e) / 11 (e), after phase 11: attention whose query heads do not
   split evenly over ``model``, three processes on the one GPU (a (data
   1, model 3) mesh over gloo, ``--heads-rank R``, files under
   ``build/heads_phase/``), each run held to a one-process oracle run
   and freed first: (e1) qwen2.5-14b at its published widths cut to 2 of
   48 layers (2.1 B params, 8.4 GB f32; its 40 heads in blocks of 14, 14
   and 12 reading KV heads 0-2, 2-5 and 5-7), (e2) whisper-small whole
   (12 heads, 4 a rank, in the encoder, the decoder and the cross
   attention); each served from the rank's ``param_specs`` blocks
   (``prefill`` of 2 x 1000, whisper's 2 x 200 with frames, then 16
   ``decode_step(page_impl="sp")`` steps: the oracle's tokens on every
   rank but at near-ties) and trained 2 steps of (2, 1024) (loss, grad
   norm and each leaf's sum of squares within 1e-5 relative, those that
   start at zero, qwen2.5's QKV biases, within 1e-4); each run
   prints the rank's heads, its resident GB beside the whole model's,
   prefill seconds, decode tokens/s, the collectives' calls and GB and
   seconds a step.  No kernel launches;
12. the dry run (``repro_torch.launch.dryrun``), after every timed
   phase, in two subprocesses run side by side (``--dryrun-phase``,
   files under ``build/dryrun_phase/``) on fake tensors and fake process
   groups, so no group meets phase 11's gloo ranks: (a) phase 11's
   steps (granite on both meshes, DeepSeek-MoE expert-parallel, (d)'s
   three tensor-parallel mixers) as rank
   0 of 2 fake ranks on fake CUDA tensors, whose collective calls and
   bytes must equal phase 11's at every step, its resident state be
   within 2% of phase 11's ``memory_allocated`` before the first step,
   its MemTracker peak within 15% of ``max_memory_allocated`` and, for
   granite, its FLOPs on both ranks equal phase 9's count of what eager
   runs (``train_flops``); phase 10 (d)'s two granite serving runs
   replayed as a prefill and a decode cell on 2 fake ranks, whose calls
   and bytes must equal the measured prefill's and every decode step's
   and whose resident state must be within 2% of the measured; (e1)'s
   training step, prefill and decode replayed the same way as rank 0 of
   3 fake ranks; (b)
   granite-3-8b cut to 4 of 40 layers x train_4k on the 256-rank fake
   production mesh (meta tensors; its attention tensor-parallel with
   the 8 KV heads whole on every rank), its record line and useful-FLOP
   share printed.

Prints the card's name and power limit, tokens/s per run, one wall-time
line per phase, the script's wall time, one
``{"kernels": [...]}`` JSON line (one entry per TPU kernel of the
reference) and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without a CUDA device or without the rest of the
repository beside it.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3 (data sheet)
PEAK_F32_S = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_TF32_S = 495e12        # H100 SXM TF32 on the tensor cores (dense)
PEAK_BF16_S = 989e12        # H100 SXM bf16 on the tensor cores (dense)
# H100 SXM ex2 on the SFUs: 16 a clock on each of 132 SMs at the 1.98 GHz
# boost clock (CUDA programming guide, arithmetic instruction throughput)
PEAK_EX2_S = 16 * 132 * 1.98e9
TOL = 2e-5                  # f32: kernel and plain version sum in other orders
PA = "src/repro/kernels/paged_attention/paged_attention.py"
CU = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
MLA_PY = "src/repro/kernels/mla_attention/mla_attention.py"
MLA_CU = "src/repro_torch/kernels/mla_attention/csrc/mla_attention.cu"

# granite-3-8b attention geometry (configs/granite_3_8b.py)
KV, G, HD, BS = 8, 4, 128, 128
B, M = 8, 32
DEVICE = "cuda"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def cut_config(arch: str, layers: int):
    """``arch``'s published config cut to its first ``layers`` layers."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    return full.with_(n_layers=layers, mixers=full.mixers[:layers],
                      ffns=full.ffns[:layers])


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Median CUDA-event time of one replay of ``fn`` captured in a CUDA
    graph: the device time of its launches, without the host's work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, reps)


@contextlib.contextmanager
def timed_calls(torch, module, name: str):
    """Patch ``module.name`` so that each call is bracketed by CUDA events
    (which neither block the host nor change the run); yields the list of
    (start, end) pairs, one per call."""
    calls: list = []
    inner = getattr(module, name)

    def call(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **k)
        end.record()
        calls.append((start, end))
        return out
    with mock.patch.object(module, name, call):
        yield calls


def span_line(calls, what: str) -> str:
    """The stream time the calls spanned, in all and per call."""
    secs = sum(s.elapsed_time(e) for s, e in calls) / 1e3
    return (f"its {len(calls)} {what} calls spanned {secs:.4f} s of stream "
            f"time, {secs / max(len(calls), 1) * 1e3:.4f} ms per call")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def tf32_passes(a_bf16: bool, b_bf16: bool) -> int:
    """TF32 tensor-core passes of an exact f32 product of two operands: a
    bf16 value is exact in TF32 (one part), an f32 value is two (its high
    and low TF32 halves), and the cross term of two low halves is
    dropped, as 3xTF32 does: 1 pass for bf16 x bf16, 2 for one f32
    operand, 3 for two."""
    return 3 - a_bf16 - b_bf16


def bound_bf16(nbytes: float, qk_flops: float, pv_flops: float, *,
               q_bf16: bool, kv_bf16: bool) -> tuple[float, str, float]:
    """The bound of attention computed exactly in f32 over inputs of which
    q and/or the keys and values are bf16: Q.K^T's ``qk_flops`` at
    ``tf32_passes(q, k)`` passes, P.V's ``pv_flops`` at ``tf32_passes(P,
    v)`` (P is f32: 2 passes over a bf16 V, 3 over an f32 one), and
    ``nbytes`` counted at each input's element size by the caller.
    Returns (ms, what bounds it, the bound at the bf16 tensor-core peak,
    which would round q and P to bf16)."""
    t_b = nbytes / PEAK_BYTES_S
    t_f = (tf32_passes(q_bf16, kv_bf16) * qk_flops
           + tf32_passes(False, kv_bf16) * pv_flops) / PEAK_TF32_S
    tc_ms = max(t_b, (qk_flops + pv_flops) / PEAK_BF16_S) * 1e3
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations",
            tc_ms)


# ----------------------------------------------------------- kernel cases
def stack_tables(torch, tables, W):
    """(B, M) → the (W, Bs, M) shard stack (slot b at shard b % W)."""
    Bt, Mt = tables.shape
    Bs = -(-Bt // W)
    stack = torch.full((W, Bs, Mt), -1, dtype=torch.int32,
                       device=tables.device)
    for b in range(Bt):
        stack[b % W, b // W] = tables[b]
    return stack


def decode_case(torch, gen, *, W, holes, window, kv=KV, g=G, hd=HD):
    dev = DEVICE
    N = B * M + 16
    kv_pool = torch.randn(N, BS, 2 * kv, hd, generator=gen, device=dev)
    q = torch.randn(B, kv, g, hd, generator=gen, device=dev)
    phys = torch.randperm(N, generator=gen, device=dev)[:B * M]
    tables = phys.reshape(B, M).to(torch.int32)
    lengths = torch.randint(1, M * BS + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = M * BS                      # a full table
    lengths[-1] = 0                          # an inactive slot
    tables[-1] = -1
    if holes:                                # never the block of pos len-1
        for b in range(1, B - 1, 2):
            last = (int(lengths[b]) - 1) // BS
            for m in (1, 3, 7):
                if m != last:
                    tables[b, m] = -1
    return dict(q=q, kv_pool=kv_pool, tables=tables,
                stack=stack_tables(torch, tables, W), lengths=lengths,
                window=window)


def decode_work(c, pool_es: int = 4, q_es: int = 4):
    """(visible K/V tokens over all heads' slots, bytes, flops) this case's
    data needs: each visible K/V row read once, q read, out written (pool
    and q elements of ``pool_es`` and ``q_es`` bytes)."""
    tables = c["tables"].cpu().numpy()
    tokens = 0
    for b, n in enumerate(c["lengths"].cpu().tolist()):
        lo = max(0, n - c["window"]) if c["window"] else 0
        for pos in range(lo, n):
            if tables[b, pos // BS] >= 0:
                tokens += 1
    nbytes = (tokens * KV * 2 * HD * pool_es + 2 * B * KV * G * HD * q_es
              + tables.size * 4 + B * 4)
    flops = tokens * KV * G * 4 * HD
    return tokens, nbytes, flops


def ragged_case(torch, gen, *, window, kv=KV, g=G, hd=HD):
    """Mixed batch: unaligned prefill chunks (one resuming mid-prompt),
    decode rows (one over a hole), an inactive slot; engine-like t_cap;
    4096 keys a slot, so split-K."""
    from repro_torch.kernels.paged_attention.ops import \
        build_ragged_descriptor
    dev = DEVICE
    #         slot, q_len, q_start
    rows = [(0, 300, 0), (1, 200, 256), (2, 77, 1024), (3, 1, 1999),
            (4, 1, 0), (5, 1, 4095), (6, 256, 512)]
    N = B * M + 16
    kv_pool = torch.randn(N, BS, 2 * kv, hd, generator=gen, device=dev)
    phys = torch.randperm(N, generator=gen, device=dev)[:B * M]
    tables = phys.reshape(B, M).to(torch.int32)
    for slot, qn, start in rows:             # unallocated tail blocks
        tables[slot, -(-(start + qn) // BS):] = -1
    tables[7] = -1                           # inactive slot
    tables[3, 5] = -1                        # a hole in decode history
    d = build_ragged_descriptor(
        [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
        [r[1] + r[2] for r in rows], num_slots=B, t_cap=B * 2 * BS)
    T = d["token_row"].shape[0]
    q = torch.randn(T, kv, g, hd, generator=gen, device=dev)
    t = {k: torch.as_tensor(d[k], device=dev)
         for k in ("token_row", "token_pos", "tile_row", "tile_pos",
                   "kv_lens")}
    return dict(q=q, kv_pool=kv_pool, tables=tables, window=window, **t)


def ragged_work(c, pool_es: int = 4, q_es: int = 4):
    """(bytes, flops) this case's data needs, pool and q elements of
    ``pool_es`` and ``q_es`` bytes."""
    tables = c["tables"].cpu().numpy()
    row = c["token_row"].cpu().numpy()
    pos = c["token_pos"].cpu().numpy()
    kv_lens = c["kv_lens"].cpu().numpy()
    w = c["window"]
    keys = pairs = 0
    for slot in sorted(set(row[row >= 0].tolist())):
        qp = pos[row == slot]
        seen = set()
        for p in qp.tolist():
            lo = max(0, p - w + 1) if w else 0
            vis = [k for k in range(lo, min(p, kv_lens[slot] - 1) + 1)
                   if tables[slot, k // BS] >= 0]
            pairs += len(vis)
            seen.update(vis)
        keys += len(seen)
    real = int((row >= 0).sum())
    nbytes = (keys * KV * 2 * HD * pool_es + 2 * real * KV * G * HD * q_es
              + tables.size * 4 + 3 * row.size // 8 * 4)
    flops = pairs * KV * G * 4 * HD
    return nbytes, flops


def sdpa_decode(torch, c):
    """One SDPA call over the gathered K/V of every slot (setup untimed)."""
    import torch.nn.functional as F
    tab = c["tables"].clamp(min=0).long()
    kv = c["kv_pool"][tab].reshape(B, M * BS, 2 * KV, HD)
    k = kv[:, :, 0::2].permute(0, 2, 1, 3).repeat_interleave(G, 1)
    v = kv[:, :, 1::2].permute(0, 2, 1, 3).repeat_interleave(G, 1)
    q = c["q"].reshape(B, KV * G, 1, HD)
    pos = torch.arange(M * BS, device=DEVICE)
    n = c["lengths"][:, None]
    vis = (pos < n) & (c["tables"].repeat_interleave(BS, 1) >= 0)
    if c["window"]:
        vis &= pos > n - 1 - c["window"]
    mask = vis[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def sdpa_ragged(torch, c):
    """One SDPA call: each slot's real rows against that slot's keys."""
    import torch.nn.functional as F
    row, pos = c["token_row"], c["token_pos"]
    slots = sorted(set(row[row >= 0].tolist()))
    idx = [(row == s).nonzero()[:, 0] for s in slots]
    tmax = max(len(i) for i in idx)
    S = M * BS
    qs = torch.zeros(len(slots), KV * G, tmax, HD, dtype=c["q"].dtype,
                     device=DEVICE)
    mask = torch.zeros(len(slots), 1, tmax, S, dtype=torch.bool,
                       device=DEVICE)
    kpos = torch.arange(S, device=DEVICE)
    for j, (s, i) in enumerate(zip(slots, idx)):
        qs[j, :, :len(i)] = c["q"][i].reshape(len(i), KV * G, HD).transpose(0, 1)
        qp = pos[i][:, None]
        vis = ((kpos <= qp) & (kpos < c["kv_lens"][s])
               & (c["tables"][s].repeat_interleave(BS) >= 0))
        if c["window"]:
            vis &= kpos > qp - c["window"]
        mask[j, 0, :len(i)] = vis
        mask[j, 0, len(i):, 0] = True        # padded rows: one key, no NaN
    tab = c["tables"][slots].clamp(min=0).long()
    kv = c["kv_pool"][tab].reshape(len(slots), S, 2 * KV, HD)
    k = kv[:, :, 0::2].permute(0, 2, 1, 3).repeat_interleave(G, 1)
    v = kv[:, :, 1::2].permute(0, 2, 1, 3).repeat_interleave(G, 1)
    return lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=mask)


# the (q, pool) element types the paged kernels take besides (f32, f32)
BF16_PAIRS = (("float32", "bfloat16"), ("bfloat16", "bfloat16"),
              ("bfloat16", "float32"))
# a bf16 output against its plain version: one bf16 ulp (2**-7 of the
# value) and an absolute floor for outputs near 0
BF16_TOL = dict(atol=1e-5, rtol=8e-3)
# the cases whose f32 outputs f32_hashes hashes: granite's heads, then
# whisper-small's (12 KV heads of 64, G 1) and a head of 120 (decode); the
# ragged kernel at 128 (KQ 4), 64 (KQ 2) and 96 (KQ 3), each over 8 splits
HASH_DECODE = (dict(W=1, holes=True, window=None),
               dict(W=4, holes=True, window=None),
               dict(W=1, holes=False, window=1000),
               dict(W=4, holes=True, window=1000),
               dict(W=1, holes=True, window=None, kv=12, g=1, hd=64),
               dict(W=2, holes=True, window=1000, kv=2, g=4, hd=120))
HASH_RAGGED = (dict(window=None), dict(window=700),
               dict(window=None, kv=2, g=2, hd=64),
               dict(window=300, kv=2, g=4, hd=96))
# flash at Jamba's (causal) and danube's (window) widths and at hd 36 (rows
# of 8-byte bf16 copies); MLA at DeepSeek-V2's widths, 8 splits a slot
HASH_FLASH = (dict(B=1, S=4096, H=32, KV=8, hd=128, window=None),
              dict(B=1, S=6144, H=32, KV=8, hd=120, window=4096),
              dict(B=2, S=1000, H=4, KV=2, hd=36, window=None))
HASH_MLA = (1, 4)


def pair_name(qn: str, pn: str, other: str = "pool") -> str:
    short = {"float32": "f32", "bfloat16": "bf16"}
    return f"q {short[qn]} / {other} {short[pn]}"


def plain_err(torch, got, plain, what: str, scale: float = 1.0) -> float:
    """Max abs error of a kernel output against its plain version at the
    same dtypes, gated at TOL x ``scale`` for an f32 output and one bf16
    ulp for a bf16 one."""
    err = (got.float() - plain.float()).abs()
    if got.dtype == torch.float32:
        bad = (not math.isfinite(err.max().item())
               or err.max().item() > TOL * scale)
    else:
        lim = BF16_TOL["atol"] + BF16_TOL["rtol"] * plain.float().abs()
        bad = not bool(torch.isfinite(err).all()) or bool((err > lim).any())
    if bad:
        fail(f"{what}: max abs err {err.max().item()} against the plain "
             f"version")
    return err.max().item()


def f32_hashes(torch, seed: int) -> dict:
    """sha256 of the f32 output of each attention kernel on seeded cases:
    decode fused (depth 1) and over split pools in the HASH_DECODE cases,
    ragged in the HASH_RAGGED cases, flash (causal) in the HASH_FLASH
    cases and MLA at DeepSeek-V2's widths with W in HASH_MLA.  The same
    function run against another checkout's package
    (``tools/paged_f32_hashes.py --root DIR``) says whether its f32
    kernels give the same bits."""
    import hashlib
    from repro_torch.kernels.flash_attention import flash_attention as fak
    from repro_torch.kernels.mla_attention import mla_attention as mk
    from repro_torch.kernels.paged_attention import paged_attention as pa
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 101)
    outs = {}
    def label(case):
        return " ".join(f"{k}={v}" for k, v in case.items())

    for case in HASH_DECODE:
        c = decode_case(torch, gen, **case)
        q, pool, stack, lengths = c["q"], c["kv_pool"], c["stack"], \
            c["lengths"]
        window = case["window"]
        name = f"decode {label(case)}"
        outs[f"{name} fused"] = pa.paged_attention_fused_fwd(
            q, pool, stack, lengths, window=window, buffer_depth=1)
        outs[f"{name} split"] = pa.paged_attention_fwd(
            q, pool[:, :, 0::2].contiguous(), pool[:, :, 1::2].contiguous(),
            stack, lengths, window=window)
    for case in HASH_RAGGED:
        c = ragged_case(torch, gen, **case)
        outs[f"ragged {label(case)}"] = pa.ragged_fused_fwd(
            c["q"], c["kv_pool"], stack_tables(torch, c["tables"], 1),
            c["tile_row"], c["tile_pos"], c["kv_lens"],
            window=case["window"])
    for case in HASH_FLASH:
        q, k, v = flash_inputs(torch, gen, **case)
        outs[f"flash {label(case)}"] = fak.flash_attention_fwd(
            *(x.transpose(1, 2).contiguous() for x in (q, k, v)),
            causal=True, window=case["window"])
        del q, k, v
    for W in HASH_MLA:
        c = mla_case(torch, gen, W=W)
        outs[f"mla W={W}"] = mk.mla_paged_ctx_fwd(
            c["q_lat"], c["q_rope"], c["c"], c["kr"], c["stack"],
            c["lengths"], scale=MLA_SCALE)
    torch.cuda.synchronize()
    return {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
            for k, v in outs.items()}


def kernel_phase(torch, seed: int) -> list[dict]:
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.kernels.paged_attention import split as split_mod
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    for name, h in f32_hashes(torch, seed).items():
        print(f"f32 sha256 {name}: {h}")

    # ---- paged decode kernel: depths 1/2/4 and split, W, holes, window;
    # f32, then the other (q, pool) pairs against the f32 kernel
    a_err = 0.0
    bf16_err = {pair_name(*p): 0.0 for p in BF16_PAIRS}
    for W, holes, window in ((1, True, None), (4, True, None),
                             (1, False, 1000), (4, True, 1000)):
        c = decode_case(torch, gen, W=W, holes=holes, window=window)
        q, pool, stack, lengths = c["q"], c["kv_pool"], c["stack"], \
            c["lengths"]
        outs = {d: pa.paged_attention_fused_fwd(q, pool, stack, lengths,
                                                window=window,
                                                buffer_depth=d)
                for d in (1, 2, 4)}
        k_pool = pool[:, :, 0::2].contiguous()
        v_pool = pool[:, :, 1::2].contiguous()
        split = pa.paged_attention_fwd(q, k_pool, v_pool, stack, lengths,
                                       window=window)
        plain = ref.paged_decode_attention_fused_ref(
            q.reshape(B, KV * G, HD), pool, stack, lengths,
            window=window).reshape(B, KV, G, HD)
        torch.cuda.synchronize()
        if not (torch.equal(outs[1], outs[2]) and torch.equal(outs[1],
                                                              outs[4])):
            fail(f"decode depths 1/2/4 differ (W={W}, window={window})")
        active = lengths > 0
        if not torch.equal(outs[1][~active],
                           torch.zeros_like(outs[1][~active])):
            fail("decode kernel wrote non-zero rows for an inactive slot")
        case_err = 0.0
        for name, o in (("fused", outs[1]), ("split", split)):
            err = (o[active] - plain[active]).abs().max().item()
            if not math.isfinite(err) or err > TOL:
                fail(f"decode {name} W={W} window={window}: max abs err "
                     f"{err} > {TOL}")
            case_err = max(case_err, err)
        a_err = max(a_err, case_err)
        print(f"decode W={W} holes={holes} window={window}: depths 1/2/4 "
              f"bit-identical, max abs err vs plain {case_err:.3g}, split == "
              f"fused: {torch.equal(split, outs[1])}")
        for qn, pn in BF16_PAIRS:
            qd, pd = getattr(torch, qn), getattr(torch, pn)
            what = f"decode {pair_name(qn, pn)} W={W} window={window}"
            qt, pt = q.to(qd), pool.to(pd)
            kt, vt = k_pool.to(pd), v_pool.to(pd)
            got = {d: pa.paged_attention_fused_fwd(qt, pt, stack, lengths,
                                                   window=window,
                                                   buffer_depth=d)
                   for d in (1, 2, 4)}
            got_split = pa.paged_attention_fwd(qt, kt, vt, stack, lengths,
                                               window=window)
            want = pa.paged_attention_fused_fwd(
                qt.float(), pt.float(), stack, lengths,
                window=window).to(qd)
            want_split = pa.paged_attention_fwd(
                qt.float(), kt.float(), vt.float(), stack, lengths,
                window=window).to(qd)
            plain = ref.paged_decode_attention_fused_ref(
                qt.reshape(B, KV * G, HD), pt, stack, lengths,
                window=window).reshape(B, KV, G, HD)
            torch.cuda.synchronize()
            if any(o.dtype != qd for o in (*got.values(), got_split)):
                fail(f"{what}: output dtype is not q's")
            if not (torch.equal(got[1], got[2])
                    and torch.equal(got[1], got[4])):
                fail(f"{what}: depths 1/2/4 differ")
            if not (torch.equal(got[1], want)
                    and torch.equal(got_split, want_split)):
                fail(f"{what}: not the f32 kernel on the upcast inputs "
                     f"rounded to q's dtype")
            err = max(plain_err(torch, o[active], plain[active], what)
                      for o in (got[1], got_split))
            bf16_err[pair_name(qn, pn)] = max(bf16_err[pair_name(qn, pn)],
                                              err)
            print(f"{what}: depths 1/2/4 and split pools == the f32 kernel "
                  f"on the upcast inputs rounded to q's dtype; max abs err "
                  f"vs plain {err:.3g}")

    # timing at the engine's layout (W=1, holes, no window): f32, then
    # q and pool in bf16
    c = decode_case(torch, gen, W=1, holes=True, window=None)
    q, pool, stack, lengths = c["q"], c["kv_pool"], c["stack"], c["lengths"]
    tokens, nbytes, flops = decode_work(c)
    b_ms, b_by = bound(nbytes, flops)
    plain_ms = time_ms(torch, lambda: ref.paged_decode_attention_fused_ref(
        q.reshape(B, KV * G, HD), pool, stack, lengths))
    lib_ms = time_ms(torch, sdpa_decode(torch, c))
    k_pool = pool[:, :, 0::2].contiguous()
    v_pool = pool[:, :, 1::2].contiguous()
    qb, pb = q.bfloat16(), pool.bfloat16()
    kb, vb = k_pool.bfloat16(), v_pool.bfloat16()
    _, nbytes16, _ = decode_work(c, pool_es=2, q_es=2)
    b16_ms, b16_by, tc16_ms = bound_bf16(nbytes16, flops / 2, flops / 2,
                                         q_bf16=True, kv_bf16=True)
    plain16_ms = time_ms(torch, lambda: ref.paged_decode_attention_fused_ref(
        qb.reshape(B, KV * G, HD), pb, stack, lengths))
    lib16_ms = time_ms(torch, sdpa_decode(torch, dict(c, q=qb, kv_pool=pb)))
    variants = []
    for name, replaces, fn, fn16 in (
            ("fused depth 1", f"{PA}:239",
             lambda: pa.paged_attention_fused_fwd(
                 q, pool, stack, lengths, buffer_depth=1),
             lambda: pa.paged_attention_fused_fwd(
                 qb, pb, stack, lengths, buffer_depth=1)),
            ("fused depth 2", f"{PA}:352",
             lambda: pa.paged_attention_fused_fwd(
                 q, pool, stack, lengths, buffer_depth=2),
             lambda: pa.paged_attention_fused_fwd(
                 qb, pb, stack, lengths, buffer_depth=2)),
            ("fused depth 4", f"{PA}:352",
             lambda: pa.paged_attention_fused_fwd(
                 q, pool, stack, lengths, buffer_depth=4),
             lambda: pa.paged_attention_fused_fwd(
                 qb, pb, stack, lengths, buffer_depth=4)),
            ("split", f"{PA}:152",
             lambda: pa.paged_attention_fwd(
                 q, k_pool, v_pool, stack, lengths),
             lambda: pa.paged_attention_fwd(qb, kb, vb, stack, lengths))):
        ms, g_ms = time_ms(torch, fn), graph_ms(torch, fn)
        ms16, g16_ms = time_ms(torch, fn16), graph_ms(torch, fn16)
        variants.append(dict(name=name, replaces=replaces, ms=ms,
                             graph_ms=g_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, bf16_ms=ms16,
                             bf16_graph_ms=g16_ms, bf16_plain_ms=plain16_ms,
                             bf16_bound_ms=b16_ms, bf16_bound_by=b16_by,
                             bf16_bound_bf16tc_ms=tc16_ms,
                             bf16_library_ms=lib16_ms))
        print(f"decode {name}: {ms:.4f} ms per eager call "
              f"({nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.1%} of the bound)"
              f", {g_ms:.4f} ms as a graph replay ({nbytes / g_ms / 1e6:.1f}"
              f" GB/s, {b_ms / g_ms:.1%}); bound {b_ms:.4f} ms by {b_by}; "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; {tokens} "
              f"visible K/V rows")
        print(f"decode {name} bf16 (q and pool): {ms16:.4f} ms per eager "
              f"call ({nbytes16 / ms16 / 1e6:.1f} GB/s, {b16_ms / ms16:.1%}"
              f" of the bound), {g16_ms:.4f} ms as a graph replay "
              f"({nbytes16 / g16_ms / 1e6:.1f} GB/s, {b16_ms / g16_ms:.1%});"
              f" bound {b16_ms:.4f} ms by {b16_by} (bf16 tensor-core peak "
              f"{tc16_ms:.4f}); plain {plain16_ms:.4f} ms, sdpa bf16 "
              f"{lib16_ms:.4f} ms")
    nsplit = split_mod.num_splits(M * BS, split_mod.DECODE_SPLIT)
    print(f"decode split-K: {nsplit} splits of {split_mod.DECODE_SPLIT} keys,"
          f" scratch {split_mod.scratch_bytes(q.shape, nsplit)} bytes")
    # one line per TPU kernel: split (:152), fused (:239) and the pipelined
    # fused kernel (:352) at depth 2, with depth 4 as a variant
    timing = ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    timing16 = (*(f"bf16_{k}" for k in timing), "bf16_bound_bf16tc_ms")
    decode = [dict(name=f"paged_decode_kernel ({v['name']})", route="cuda",
                   source=CU, replaces=v["replaces"], launches=0,
                   max_abs_err=a_err, **{k: v[k] for k in timing},
                   bf16_max_abs_err=dict(bf16_err), bf16_launches=0,
                   **{k: v[k] for k in timing16})
              for v in (variants[3], variants[0], variants[1])]
    decode[2]["variants"] = [variants[2]]

    # ---- ragged kernel: mixed batch, real rows only, with and without
    # window; f32, then the other (q, pool) pairs against the f32 kernel
    b_err = 0.0
    rb16_err = {pair_name(*p): 0.0 for p in BF16_PAIRS}
    for window in (None, 700):
        c = ragged_case(torch, gen, window=window)
        stack = stack_tables(torch, c["tables"], 1)
        desc = (c["tile_row"], c["tile_pos"], c["kv_lens"])
        o = pa.ragged_fused_fwd(c["q"], c["kv_pool"], stack, *desc,
                                window=window)
        plain = ref.ragged_fused_ref(
            c["q"].reshape(-1, KV * G, HD), c["kv_pool"], c["tables"],
            c["token_row"], c["token_pos"], c["kv_lens"],
            window=window).reshape(o.shape)
        torch.cuda.synchronize()
        real = c["token_row"] >= 0
        if not torch.isfinite(o).all():
            fail(f"ragged kernel output not finite (window={window})")
        err = (o[real] - plain[real]).abs().max().item()
        if not math.isfinite(err) or err > TOL:
            fail(f"ragged window={window}: max abs err {err} > {TOL}")
        b_err = max(b_err, err)
        print(f"ragged window={window}: {int(real.sum())} real rows of "
              f"{real.numel()}, max abs err vs plain {err:.3g}")
        for qn, pn in BF16_PAIRS:
            qd, pd = getattr(torch, qn), getattr(torch, pn)
            what = f"ragged {pair_name(qn, pn)} window={window}"
            qt, pt = c["q"].to(qd), c["kv_pool"].to(pd)
            got = pa.ragged_fused_fwd(qt, pt, stack, *desc, window=window)
            want = pa.ragged_fused_fwd(qt.float(), pt.float(), stack, *desc,
                                       window=window).to(qd)
            plain = ref.ragged_fused_ref(
                qt.reshape(-1, KV * G, HD), pt, c["tables"], c["token_row"],
                c["token_pos"], c["kv_lens"],
                window=window).reshape(got.shape)
            torch.cuda.synchronize()
            if got.dtype != qd or not torch.equal(got, want):
                fail(f"{what}: not the f32 kernel on the upcast inputs "
                     f"rounded to q's dtype")
            err = plain_err(torch, got[real], plain[real], what)
            rb16_err[pair_name(qn, pn)] = max(rb16_err[pair_name(qn, pn)],
                                              err)
            print(f"{what}: == the f32 kernel on the upcast inputs rounded "
                  f"to q's dtype; max abs err vs plain {err:.3g}")
    c = ragged_case(torch, gen, window=None)
    stack = stack_tables(torch, c["tables"], 1)
    nbytes, flops = ragged_work(c)
    b_ms, b_by = bound(nbytes, flops)
    def run():
        return pa.ragged_fused_fwd(c["q"], c["kv_pool"], stack,
                                   c["tile_row"], c["tile_pos"],
                                   c["kv_lens"])
    ms, g_ms = time_ms(torch, run), graph_ms(torch, run)
    # the same work on the tensor cores in 3xTF32: three TF32 products per
    # f32 product
    tc_ms = max(nbytes / PEAK_BYTES_S, 3 * flops / PEAK_TF32_S) * 1e3
    plain_ms = time_ms(torch, lambda: ref.ragged_fused_ref(
        c["q"].reshape(-1, KV * G, HD), c["kv_pool"], c["tables"],
        c["token_row"], c["token_pos"], c["kv_lens"]), reps=5)
    lib_ms = time_ms(torch, sdpa_ragged(torch, c))
    keys = M * BS
    split = split_mod.ragged_split(keys, c["q"].shape)
    nsplit = split_mod.num_splits(keys, split)
    print(f"ragged: {ms:.4f} ms per eager call ({flops / ms / 1e9:.2f} "
          f"TFLOP/s), {g_ms:.4f} ms as a graph replay "
          f"({flops / g_ms / 1e9:.2f} TFLOP/s); f32 CUDA-core bound "
          f"{b_ms:.4f} ms by {b_by} "
          f"({b_ms / ms:.1%} of it eager, {b_ms / g_ms:.1%} as a replay); "
          f"3xTF32 tensor-core bound {tc_ms:.4f} ms ({tc_ms / ms:.1%}, "
          f"{tc_ms / g_ms:.1%}); plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms")
    print(f"ragged split-K: {nsplit} splits of {split} keys, scratch "
          f"{split_mod.scratch_bytes(c['q'].shape, nsplit)} bytes")
    # q and pool in bf16: half the bytes, the same f32 operations, which
    # bf16 inputs let the tensor cores do in 1.5 TF32 passes, not 3
    c16 = dict(c, q=c["q"].bfloat16(), kv_pool=c["kv_pool"].bfloat16())
    nbytes16, _ = ragged_work(c, pool_es=2, q_es=2)
    b16_ms, b16_by, tc16_ms = bound_bf16(nbytes16, flops / 2, flops / 2,
                                         q_bf16=True, kv_bf16=True)
    def run16():
        return pa.ragged_fused_fwd(c16["q"], c16["kv_pool"], stack,
                                   c["tile_row"], c["tile_pos"],
                                   c["kv_lens"])
    ms16, g16_ms = time_ms(torch, run16), graph_ms(torch, run16)
    plain16_ms = time_ms(torch, lambda: ref.ragged_fused_ref(
        c16["q"].reshape(-1, KV * G, HD), c16["kv_pool"], c["tables"],
        c["token_row"], c["token_pos"], c["kv_lens"]), reps=5)
    lib16_ms = time_ms(torch, sdpa_ragged(torch, c16))
    print(f"ragged bf16 (q and pool): {ms16:.4f} ms per eager call, "
          f"{g16_ms:.4f} ms as a graph replay ({flops / g16_ms / 1e9:.2f} "
          f"TFLOP/s); bound {b16_ms:.4f} ms by {b16_by} (1 TF32 pass for "
          f"Q.K^T, 2 for P.V; {b16_ms / g16_ms:.1%} of it as a replay), "
          f"bf16 tensor-core peak {tc16_ms:.4f} ms; plain "
          f"{plain16_ms:.4f} ms, sdpa bf16 {lib16_ms:.4f} ms")
    b = dict(name="ragged_kernel", route="cuda", source=CU,
             replaces=f"{PA}:464", launches=0, max_abs_err=b_err, ms=ms,
             graph_ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             bound_3xtf32_ms=tc_ms, library_ms=lib_ms,
             bf16_max_abs_err=dict(rb16_err), bf16_launches=0, bf16_ms=ms16,
             bf16_graph_ms=g16_ms, bf16_plain_ms=plain16_ms,
             bf16_bound_ms=b16_ms, bf16_bound_by=b16_by,
             bf16_bound_bf16tc_ms=tc16_ms, bf16_library_ms=lib16_ms)
    return decode + [b]


# ------------------------------------------ paged kernels at new head shapes
# the head shapes the whisper and InternVL2 phases give the paged kernels:
# whisper-small decode (MHA, 12 KV heads of 64: one query head a CTA) and
# InternVL2-26B decode and ragged (8 KV heads of 128, G 6: the ragged
# kernel's cap, 48 MMA rows a tile)
HEAD_SHAPES = (("whisper-small", 12, 1, 64), ("internvl2-26b", 8, 6, 128))
#      slot, q_len, q_start: prefill chunks and decode rows, t_cap 2048
HEAD_RAGGED_ROWS = ((0, 256, 0), (1, 256, 512), (2, 1, 1400), (3, 1, 0),
                    (4, 77, 900), (5, 1, 2047))


def head_shape_phase(torch, seed: int, decode_row: dict,
                     ragged_row: dict) -> None:
    """The paged decode kernel (depth 2) at both head shapes and the ragged
    kernel at InternVL2's, against their plain versions on the card, timed
    beside their bounds; each result goes into its row's ``shapes``."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.kernels.paged_attention.ops import \
        build_ragged_descriptor
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    nb, mb = 8, 16                           # slots, blocks each
    for name, kv, g, hd in HEAD_SHAPES:
        pool = torch.randn(nb * mb, BS, 2 * kv, hd, generator=gen,
                           device=DEVICE)
        tables = torch.randperm(nb * mb, generator=gen, device=DEVICE
                                ).reshape(nb, mb).to(torch.int32)
        stack = stack_tables(torch, tables, 1)
        lengths = torch.randint(1, mb * BS + 1, (nb,), generator=gen,
                                device=DEVICE, dtype=torch.int32)
        q = torch.randn(nb, kv, g, hd, generator=gen, device=DEVICE)

        def run():
            return pa.paged_attention_fused_fwd(q, pool, stack, lengths,
                                                buffer_depth=2)

        def plain():
            return ref.paged_decode_attention_fused_ref(
                q.reshape(nb, kv * g, hd), pool, stack, lengths)
        err = (run() - plain().reshape(q.shape)).abs().max().item()
        if not math.isfinite(err) or err > TOL:
            fail(f"decode at {name}'s heads: max abs err {err} > {TOL}")
        rows = int(lengths.sum())
        nbytes = (rows * 2 * kv * hd * 4 + 2 * q.numel() * 4
                  + tables.numel() * 4 + nb * 4)
        b_ms, b_by = bound(nbytes, rows * kv * g * 4 * hd)
        ms, g_ms = time_ms(torch, run), graph_ms(torch, run)
        plain_ms = time_ms(torch, plain)
        decode_row.setdefault("shapes", []).append(dict(
            name=name, KV=kv, G=g, hd=hd, max_abs_err=err, ms=ms,
            graph_ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"decode at {name}'s heads (KV {kv}, G {g}, hd {hd}; {nb} slots"
              f", {rows} K/V rows): max abs err vs plain {err:.3g}; {ms:.4f} "
              f"ms eager, {g_ms:.4f} ms graph; bound {b_ms:.4f} ms by {b_by}"
              f" ({b_ms / g_ms:.1%} as a replay); plain {plain_ms:.4f} ms")
        if g == 1:
            continue
        r = HEAD_RAGGED_ROWS
        d = build_ragged_descriptor(
            [x[0] for x in r], [x[1] for x in r], [x[2] for x in r],
            [x[1] + x[2] for x in r], num_slots=nb, t_cap=nb * 2 * BS)
        dt = {k: torch.as_tensor(v, device=DEVICE) for k, v in d.items()}
        qr = torch.randn(dt["token_row"].shape[0], kv, g, hd, generator=gen,
                         device=DEVICE)

        def run_r():
            return pa.ragged_fused_fwd(qr, pool, stack, dt["tile_row"],
                                       dt["tile_pos"], dt["kv_lens"])

        def plain_r():
            return ref.ragged_fused_ref(
                qr.reshape(-1, kv * g, hd), pool, tables, dt["token_row"],
                dt["token_pos"], dt["kv_lens"]).reshape(qr.shape)
        real = dt["token_row"] >= 0
        err = (run_r()[real] - plain_r()[real]).abs().max().item()
        if not math.isfinite(err) or err > TOL:
            fail(f"ragged at {name}'s heads: max abs err {err} > {TOL}")
        pairs = sum(qn * s + qn * (qn + 1) // 2 for _, qn, s in r)
        keys = sum(qn + s for _, qn, s in r)
        nbytes = (keys * 2 * kv * hd * 4 + 2 * int(real.sum()) * kv * g * hd
                  * 4 + tables.numel() * 4 + 3 * real.numel() // 8 * 4)
        flops = pairs * kv * g * 4 * hd
        b_ms, b_by = bound(nbytes, flops)
        tc_ms = max(nbytes / PEAK_BYTES_S, 3 * flops / PEAK_TF32_S) * 1e3
        ms, g_ms = time_ms(torch, run_r), graph_ms(torch, run_r)
        plain_ms = time_ms(torch, plain_r, reps=5)
        ragged_row.setdefault("shapes", []).append(dict(
            name=name, KV=kv, G=g, hd=hd, max_abs_err=err, ms=ms,
            graph_ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_3xtf32_ms=tc_ms))
        print(f"ragged at {name}'s heads ({int(real.sum())} real rows of "
              f"{real.numel()}): max abs err vs plain {err:.3g}; {ms:.4f} ms"
              f" eager, {g_ms:.4f} ms graph ({flops / g_ms / 1e9:.2f} "
              f"TFLOP/s); bound {b_ms:.4f} ms by {b_by}, 3xTF32 {tc_ms:.4f}"
              f" ms; plain {plain_ms:.4f} ms")


# --------------------------------------------------------- MLA kernel phase
# DeepSeek-V2 absorbed-MLA geometry (configs/deepseek_v2_236b.py)
MLA_H, RANK, ROPE, MLA_B, MLA_M = 128, 512, 64, 8, 16
MLA_SCALE = (128 + ROPE) ** -0.5            # (nope_hd + rope_hd)^-0.5


def mla_case(torch, gen, *, W):
    """Random latents; holes in the odd slots, slot 0 full, the last slot
    of length 0 (it sees nothing and must come out 0)."""
    dev = DEVICE
    N = MLA_B * MLA_M + 16
    phys = torch.randperm(N, generator=gen, device=dev)[:MLA_B * MLA_M]
    tables = phys.reshape(MLA_B, MLA_M).to(torch.int32)
    lengths = torch.randint(1, MLA_M * BS + 1, (MLA_B,), generator=gen,
                            device=dev, dtype=torch.int32)
    lengths[0] = MLA_M * BS
    lengths[-1] = 0
    for b in range(1, MLA_B - 1, 2):
        tables[b, [1, 3, 7]] = -1
    return dict(
        q_lat=torch.randn(MLA_B, MLA_H, RANK, generator=gen, device=dev),
        q_rope=torch.randn(MLA_B, MLA_H, ROPE, generator=gen, device=dev),
        c=torch.randn(N, BS, RANK, generator=gen, device=dev),
        kr=torch.randn(N, BS, ROPE, generator=gen, device=dev),
        tables=tables, stack=stack_tables(torch, tables, W), lengths=lengths)


def mla_work(c, pool_es: int = 4, q_es: int = 4):
    """(visible tokens, bytes, Q.K^T flops, P.V flops) this case's data
    needs: each visible latent row read once (elements of ``pool_es``
    bytes), the queries read (``q_es``), the f32 context written."""
    tables = c["tables"].cpu().numpy()
    tokens = sum(1 for b, n in enumerate(c["lengths"].cpu().tolist())
                 for pos in range(n) if tables[b, pos // BS] >= 0)
    nbytes = (tokens * (RANK + ROPE) * pool_es
              + MLA_B * MLA_H * ((RANK + ROPE) * q_es + RANK * 4)
              + tables.size * 4 + MLA_B * 4)
    return (tokens, nbytes, tokens * MLA_H * 2 * (RANK + ROPE),
            tokens * MLA_H * 2 * RANK)


def sdpa_mla(torch, c):
    """One SDPA call: q = [q_lat | q_rope], k = [c | kr], v = c over the
    gathered latents, the kernel's scale (setup untimed)."""
    import torch.nn.functional as F
    S = MLA_M * BS
    rows = c["tables"].clamp(min=0).long()
    lat = c["c"][rows].reshape(MLA_B, 1, S, RANK)
    k = torch.cat([lat, c["kr"][rows].reshape(MLA_B, 1, S, ROPE)], dim=-1)
    q = torch.cat([c["q_lat"], c["q_rope"]], dim=-1)[:, :, None]
    pos = torch.arange(S, device=DEVICE)
    vis = (pos < c["lengths"][:, None]) & (
        c["tables"].repeat_interleave(BS, 1) >= 0)
    mask = vis[:, None, None, :]
    k = k.expand(MLA_B, MLA_H, S, RANK + ROPE)
    v = lat.expand(MLA_B, MLA_H, S, RANK)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=MLA_SCALE)


def mla_kernel_phase(torch, seed: int) -> dict:
    """The MLA kernel at DeepSeek-V2's widths against its plain version,
    in f32 and in the three (queries, pools) pairs of f32 and bf16 (each
    the f32 kernel on the upcast inputs, bit for bit), timed in f32 and
    in the decode path's pair (f32 queries over bf16 pools)."""
    from repro_torch.kernels.mla_attention import mla_attention as mk
    from repro_torch.kernels.mla_attention import ref as mref
    from repro_torch.kernels.mla_attention import split as msplit
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    err = 0.0
    pair_err = {pair_name(*p): 0.0 for p in BF16_PAIRS}
    for W in (1, 4):
        c = mla_case(torch, gen, W=W)
        args = (c["q_lat"], c["q_rope"], c["c"], c["kr"], c["stack"],
                c["lengths"])
        o = mk.mla_paged_ctx_fwd(*args, scale=MLA_SCALE)
        plain = mref.mla_paged_ctx_ref(*args, scale=MLA_SCALE)
        torch.cuda.synchronize()
        if not torch.isfinite(o).all():
            fail(f"MLA kernel output not finite (W={W})")
        if o[-1].abs().max().item() != 0.0:
            fail("MLA kernel wrote non-zero context for a slot of length 0")
        e = (o - plain).abs().max().item()
        if not math.isfinite(e) or e > TOL:
            fail(f"MLA W={W}: max abs err {e} > {TOL}")
        err = max(err, e)
        print(f"mla W={W} holes=True zero-length slot: max abs err vs plain "
              f"{e:.3g}")
        for qn, pn in BF16_PAIRS:
            qd, pd = getattr(torch, qn), getattr(torch, pn)
            what = f"mla {pair_name(qn, pn)} W={W}"
            a16 = (c["q_lat"].to(qd), c["q_rope"].to(qd), c["c"].to(pd),
                   c["kr"].to(pd), c["stack"], c["lengths"])
            got = mk.mla_paged_ctx_fwd(*a16, scale=MLA_SCALE)
            want = mk.mla_paged_ctx_fwd(*(x.float() for x in a16[:4]),
                                        *a16[4:], scale=MLA_SCALE)
            plain = mref.mla_paged_ctx_ref(*a16, scale=MLA_SCALE)
            torch.cuda.synchronize()
            if got.dtype != torch.float32 or not torch.equal(got, want):
                fail(f"{what}: not the f32 kernel on the upcast inputs")
            e = plain_err(torch, got, plain, what)
            key = pair_name(qn, pn)
            pair_err[key] = max(pair_err[key], e)
            print(f"{what}: == the f32 kernel on the upcast inputs (f32 "
                  f"context); max abs err vs plain {e:.3g}")
            del a16, got, want, plain
    c = mla_case(torch, gen, W=1)
    args = (c["q_lat"], c["q_rope"], c["c"], c["kr"], c["stack"],
            c["lengths"])
    tokens, nbytes, qk, pv = mla_work(c)
    flops = qk + pv
    b_ms, b_by = bound(nbytes, flops)
    def run():
        return mk.mla_paged_ctx_fwd(*args, scale=MLA_SCALE)
    ms, g_ms = time_ms(torch, run), graph_ms(torch, run)
    # the same work on the tensor cores in 3xTF32
    tc_ms = max(nbytes / PEAK_BYTES_S, 3 * flops / PEAK_TF32_S) * 1e3
    plain_ms = time_ms(torch, lambda: mref.mla_paged_ctx_ref(
        *args, scale=MLA_SCALE))
    lib_ms = time_ms(torch, sdpa_mla(torch, c))
    nsplit = msplit.num_splits(MLA_M * BS, msplit.MLA_SPLIT)
    print(f"mla: {ms:.4f} ms per eager call, {g_ms:.4f} ms as a graph "
          f"replay (f32 CUDA-core bound {b_ms:.4f} ms by {b_by}: "
          f"{b_ms / ms:.1%} of it eager, {b_ms / g_ms:.1%} as a replay; "
          f"3xTF32 tensor-core bound {tc_ms:.4f} ms: {tc_ms / ms:.1%}, "
          f"{tc_ms / g_ms:.1%}); plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms; {tokens} visible latent rows, {flops / g_ms / 1e9:.2f} "
          f"TFLOP/s; split-K {nsplit} splits of {msplit.MLA_SPLIT} tokens, "
          f"scratch {msplit.scratch_bytes(c['q_lat'].shape, nsplit)} bytes")
    # the decode path's pair: f32 queries (absorbed through W_UK in f32)
    # over bf16 pools; Q.K^T takes 2 TF32 passes (one f32 operand), P.V 2
    args16 = (c["q_lat"], c["q_rope"], c["c"].bfloat16(), c["kr"].bfloat16(),
              c["stack"], c["lengths"])
    _, nbytes16, _, _ = mla_work(c, pool_es=2, q_es=4)
    b16_ms, b16_by, tc16_ms = bound_bf16(nbytes16, qk, pv, q_bf16=False,
                                         kv_bf16=True)
    def run16():
        return mk.mla_paged_ctx_fwd(*args16, scale=MLA_SCALE)
    ms16, g16_ms = time_ms(torch, run16), graph_ms(torch, run16)
    plain16_ms = time_ms(torch, lambda: mref.mla_paged_ctx_ref(
        *args16, scale=MLA_SCALE))
    # SDPA takes one dtype: q rounded to bf16 as well
    lib16_ms = time_ms(torch, sdpa_mla(torch, dict(
        c, q_lat=c["q_lat"].bfloat16(), q_rope=c["q_rope"].bfloat16(),
        c=args16[2], kr=args16[3])))
    print(f"mla q f32 / pool bf16: {ms16:.4f} ms per eager call, "
          f"{g16_ms:.4f} ms as a graph replay ({nbytes16 / g16_ms / 1e6:.1f} "
          f"GB/s, {flops / g16_ms / 1e9:.2f} TFLOP/s); bound {b16_ms:.4f} ms "
          f"by {b16_by} (2 TF32 passes for Q.K^T, 2 for P.V; "
          f"{b16_ms / g16_ms:.1%} of it as a replay), bf16 tensor-core peak "
          f"{tc16_ms:.4f} ms; plain {plain16_ms:.4f} ms, sdpa bf16 "
          f"{lib16_ms:.4f} ms")
    return dict(name="mla_ctx_kernel", route="cuda", source=MLA_CU,
                replaces=f"{MLA_PY}:86", launches=0, max_abs_err=err, ms=ms,
                graph_ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bound_3xtf32_ms=tc_ms, library_ms=lib_ms,
                bf16_pair=pair_name("float32", "bfloat16"),
                bf16_max_abs_err=pair_err, bf16_launches=0, bf16_ms=ms16,
                bf16_graph_ms=g16_ms, bf16_plain_ms=plain16_ms,
                bf16_bound_ms=b16_ms, bf16_bound_by=b16_by,
                bf16_bound_bf16tc_ms=tc16_ms, bf16_library_ms=lib16_ms)


# ------------------------------------------ scan and flash kernel phases
MS_PY = "src/repro/kernels/mamba_scan/mamba_scan.py"
MS_CU = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
RK_PY = "src/repro/kernels/rwkv6_scan/rwkv6_scan.py"
RK_CU = "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu"
FA_PY = "src/repro/kernels/flash_attention/flash_attention.py"
FA_CU = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
# the reference's kernel-test tolerances (tests/test_kernels.py), scaled by
# max(1, max|want|)
MS_TOL, RK_TOL = 1e-5, 2e-4
SCAN_B, SCAN_S = 2, 2000      # a multiple of no chunk of the kernels
MS_DI, MS_N, MS_R = 8192, 16, 256   # Jamba: d_inner, d_state, dt_rank
RK_NH, RK_HD = 64, 64         # RWKV-6-7B: heads, head size
# flash: Jamba's attention (causal) and h2o-danube-3-4b (window 4096)
FLASH_CASES = (dict(name="jamba causal", B=1, S=4096, H=32, KV=8, hd=128,
                    window=None),
               dict(name="danube window", B=1, S=6144, H=32, KV=8, hd=120,
                    window=4096))


def flash_inputs(torch, gen, *, B, S, H, KV, hd, window=None, name=None):
    """Random f32 q (B, S, H, hd), k and v (B, S, KV, hd) on the card, in
    the model's layout."""
    return (torch.randn(B, S, H, hd, generator=gen, device=DEVICE),
            torch.randn(B, S, KV, hd, generator=gen, device=DEVICE),
            torch.randn(B, S, KV, hd, generator=gen, device=DEVICE))


def scaled_err(got, want) -> tuple[float, float]:
    """(max abs error, its gate's scale max(1, max|want|))."""
    return ((got - want).abs().max().item(),
            max(1.0, want.abs().max().item()))


def scan_kernel_phase(torch, seed: int) -> list[dict]:
    """The Mamba and RWKV-6 scans at full width (B=2, S=2000, nonzero
    initial states), held against their plain versions and timed."""
    from repro_torch.kernels.mamba_scan import mamba_scan as msk
    from repro_torch.kernels.mamba_scan import ops as msops
    from repro_torch.kernels.mamba_scan import ref as msref
    from repro_torch.kernels.rwkv6_scan import ops as rkops
    from repro_torch.kernels.rwkv6_scan import ref as rkref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rkk
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    out = []
    B, S, DI, N = SCAN_B, SCAN_S, MS_DI, MS_N
    # B and C as the model makes them: column views of the x_proj output
    _, Bv, Cv = randn(B, S, MS_R + 2 * N).split([MS_R, N, N], dim=-1)
    args = (torch.nn.functional.softplus(randn(B, S, DI)),
            -torch.exp(0.2 * randn(DI, N)), Bv, Cv, randn(B, S, DI),
            randn(B, DI, N))
    y, h = msops.mamba_scan(*args)
    wy, wh = msref.mamba_scan_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    for what, got, want in (("y", y, wy), ("h_last", h, wh)):
        e, sc = scaled_err(got, want)
        if not math.isfinite(e) or e > MS_TOL * sc:
            fail(f"mamba_scan {what}: max abs err {e} > {MS_TOL} x {sc:.3g}")
        err = max(err, e)
    # the kernel on contiguous inputs at S 2000, and the op as the model
    # calls it (the kernel reads B and C through their strides)
    kargs = [t.contiguous() for t in args]

    def kernel():
        return msk.mamba_scan_fwd(*kargs)
    ms, g_ms = time_ms(torch, kernel), graph_ms(torch, kernel)
    op_ms = time_ms(torch, lambda: msops.mamba_scan(*args))
    plain_ms = time_ms(torch, lambda: msref.mamba_scan_ref(*args), reps=3,
                       warmup=1)
    nbytes = 4 * (3 * B * S * DI + 2 * B * S * N + DI * N + 2 * B * DI * N)
    b_ms, b_by = bound(nbytes, 7 * B * S * DI * N)
    # the exponentials on the SFUs: one ex2 per state and step
    ex2_ms = B * S * DI * N / PEAK_EX2_S * 1e3
    print(f"mamba_scan B={B} S={S} DI={DI} N={N}: max abs err vs plain "
          f"{err:.3g}; kernel {ms:.4f} ms per eager call, {g_ms:.4f} ms as "
          f"a graph replay (bound {b_ms:.4f} ms by {b_by}: {b_ms / ms:.1%} "
          f"eager, {b_ms / g_ms:.1%} replay; ex2 floor {ex2_ms:.4f} ms: "
          f"{ex2_ms / ms:.1%}, {ex2_ms / g_ms:.1%}); ops.mamba_scan "
          f"{op_ms:.4f} ms; plain {plain_ms:.4f} ms, no library call; "
          f"{msk.CHANNELS_PER_BLOCK} channels a block, a ring of "
          f"{msk.RING_STAGES} stages of {msk.STEPS_PER_STAGE} steps")
    out.append(dict(name="mamba_scan_kernel", route="cuda", source=MS_CU,
                    replaces=f"{MS_PY}:57", launches=0, max_abs_err=err,
                    ms=ms, graph_ms=g_ms, op_ms=op_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, bound_ex2_ms=ex2_ms,
                    library_ms=None))
    del kargs

    nH, hd = RK_NH, RK_HD
    sh = (B, S, nH, hd)
    args = (randn(*sh), randn(*sh), randn(*sh),
            torch.exp(-torch.exp(0.5 * randn(*sh) - 0.5)),
            0.1 * randn(nH, hd), 0.1 * randn(B, nH, hd, hd))
    # strong decays on the even heads (log w times 4, down to -5): their
    # chunks pass the kernel's decay limit and take its sequential path
    logw = torch.log(args[3])
    logw[:, :, ::2] = (4 * logw[:, :, ::2]).clamp(min=-5.0)
    strong = (*args[:3], torch.exp(logw), *args[4:])
    err = 0.0
    for case, a in (("", args), (" strong decay", strong)):
        y, st = rkops.rwkv6_scan(*a)
        wy, wst = rkref.rwkv6_scan_ref(*a)
        torch.cuda.synchronize()
        case_err = 0.0
        for what, got, want in (("y", y, wy), ("S_last", st, wst)):
            e, sc = scaled_err(got, want)
            if (not torch.isfinite(got).all() or not math.isfinite(e)
                    or e > RK_TOL * sc):
                fail(f"rwkv6_scan{case} {what}: max abs err {e} > {RK_TOL} "
                     f"x {sc:.3g} (or not finite)")
            case_err = max(case_err, e)
        err = max(err, case_err)
        slow = ~rkref.fast_chunks(a[3])
        print(f"rwkv6_scan{case} B={B} S={S} nH={nH} hd={hd}: max abs err "
              f"vs plain {case_err:.3g}; {int(slow.sum())} of {slow.numel()} "
              f"(b, chunk, head) on the sequential path")
        del y, st, wy, wst
    # the kernel on heads-major contiguous inputs, and the op as the model
    # calls it (token-major; the kernel reads it through strides)
    hm = [t.transpose(1, 2).contiguous() for t in args[:4]]

    def kernel():
        return rkk.rwkv6_scan_fwd(*hm, *args[4:])
    ms, g_ms = time_ms(torch, kernel), graph_ms(torch, kernel)
    op_ms = time_ms(torch, lambda: rkops.rwkv6_scan(*args))
    strong_ms = time_ms(torch, lambda: rkops.rwkv6_scan(*strong))
    plain_ms = time_ms(torch, lambda: rkref.rwkv6_scan_ref(*args), reps=3,
                       warmup=1)
    nbytes = 4 * (5 * B * S * nH * hd + nH * hd + 2 * B * nH * hd * hd)
    b_ms, b_by = bound(nbytes, 5 * B * nH * S * hd * hd)
    print(f"rwkv6_scan: kernel {ms:.4f} ms per eager call, {g_ms:.4f} ms as "
          f"a graph replay (bound {b_ms:.4f} ms by {b_by}: {b_ms / ms:.1%} "
          f"eager, {b_ms / g_ms:.1%} replay); ops.rwkv6_scan {op_ms:.4f} ms; "
          f"strong decay {strong_ms:.4f} ms; plain {plain_ms:.4f} ms, no "
          f"library call; {rkk.col_split(hd)} blocks per head")
    out.append(dict(name="rwkv6_scan_kernel", route="cuda", source=RK_CU,
                    replaces=f"{RK_PY}:80", launches=0, max_abs_err=err,
                    ms=ms, graph_ms=g_ms, op_ms=op_ms,
                    strong_decay_ms=strong_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return out


def flash_kernel_phase(torch, seed: int) -> dict:
    """Flash attention at Jamba's (causal) and danube's (window) widths
    against its plain version and one SDPA call (a yardstick the port
    never calls), in f32 and in the three (q, k/v) pairs of f32 and bf16
    (each the f32 kernel on the upcast inputs rounded to q's dtype, bit
    for bit), timed in f32 and with q, k and v in bf16; the Jamba case is
    the row's time."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fak
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention import ref as faref
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 4)
    err, row = 0.0, None
    pair_err = {pair_name(*p, "k/v"): 0.0 for p in BF16_PAIRS}
    for c in FLASH_CASES:
        B, S, H, KV, hd, W = (c[k] for k in ("B", "S", "H", "KV", "hd",
                                              "window"))
        q, k, v = flash_inputs(torch, gen, **c)
        got = faops.flash_attention(q, k, v, causal=True, window=W)
        want = faref.flash_attention_ref(q, k, v, causal=True, window=W)
        torch.cuda.synchronize()
        e, sc = scaled_err(got, want)
        if not math.isfinite(e) or e > TOL * sc:
            fail(f"flash {c['name']}: max abs err {e} > {TOL} x {sc:.3g}")
        err = max(err, e)
        del want
        for qn, kn in BF16_PAIRS:
            qd, kd = getattr(torch, qn), getattr(torch, kn)
            what = f"flash {c['name']} {pair_name(qn, kn, 'k/v')}"
            qt, kt, vt = q.to(qd), k.to(kd), v.to(kd)
            got16 = faops.flash_attention(qt, kt, vt, causal=True, window=W)
            want16 = faops.flash_attention(qt.float(), kt.float(), vt.float(),
                                           causal=True, window=W).to(qd)
            plain16 = faref.flash_attention_ref(qt, kt, vt, causal=True,
                                                window=W)
            torch.cuda.synchronize()
            if got16.dtype != qd or not torch.equal(got16, want16):
                fail(f"{what}: not the f32 kernel on the upcast inputs "
                     f"rounded to q's dtype")
            e16 = plain_err(torch, got16, plain16, what, scale=sc)
            key = pair_name(qn, kn, "k/v")
            pair_err[key] = max(pair_err[key], e16)
            print(f"{what}: == the f32 kernel on the upcast inputs rounded "
                  f"to q's dtype; max abs err vs plain {e16:.3g}")
            del qt, kt, vt, got16, want16, plain16
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def kernel():
            return fak.flash_attention_fwd(qh, kh, vh, causal=True, window=W)
        ms, g_ms = time_ms(torch, kernel), graph_ms(torch, kernel)
        op_ms = time_ms(torch, lambda: faops.flash_attention(
            q, k, v, causal=True, window=W))
        plain_ms = time_ms(torch, lambda: faref.flash_attention_ref(
            q, k, v, causal=True, window=W), reps=5, warmup=1)
        if W is None:
            sdpa = dict(is_causal=True)
        else:
            pos = torch.arange(S, device=DEVICE)
            sdpa = dict(attn_mask=(pos[:, None] >= pos)
                        & (pos[:, None] - pos < W))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, enable_gqa=True, **sdpa))
        pairs = sum(min(i + 1, W or S) for i in range(S))
        nbytes = 4 * B * S * (2 * H + 2 * KV) * hd
        flops = 4 * hd * pairs * H * B
        b_ms, b_by = bound(nbytes, flops)
        # the same work on the tensor cores in 3xTF32
        tc_ms = max(nbytes / PEAK_BYTES_S, 3 * flops / PEAK_TF32_S) * 1e3
        print(f"flash {c['name']} B={B} S={S} H={H} KV={KV} hd={hd} "
              f"window={W}: max abs err vs plain {e:.3g}; kernel {ms:.4f} ms "
              f"per eager call ({flops / ms / 1e9:.2f} TFLOP/s), {g_ms:.4f} "
              f"ms as a graph replay ({flops / g_ms / 1e9:.2f} TFLOP/s); f32 "
              f"CUDA-core bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%}, "
              f"{b_ms / g_ms:.1%}); 3xTF32 tensor-core bound {tc_ms:.4f} ms "
              f"({tc_ms / ms:.1%}, {tc_ms / g_ms:.1%}); ops.flash_attention "
              f"on (B, S, H, hd) {op_ms:.4f} ms; plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms; tiles of {fak.BLOCK_Q} query rows x "
              f"{fak.BLOCK_K} keys, a ring of {fak.RING_STAGES}")
        # q, k and v in bf16: half the bytes, 1 TF32 pass for Q.K^T and 2
        # for P.V
        q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
        qh16, kh16, vh16 = (t.transpose(1, 2).contiguous()
                            for t in (q16, k16, v16))

        def kernel16():
            return fak.flash_attention_fwd(qh16, kh16, vh16, causal=True,
                                           window=W)
        ms16, g16_ms = time_ms(torch, kernel16), graph_ms(torch, kernel16)
        op16_ms = time_ms(torch, lambda: faops.flash_attention(
            q16, k16, v16, causal=True, window=W))
        plain16_ms = time_ms(torch, lambda: faref.flash_attention_ref(
            q16, k16, v16, causal=True, window=W), reps=5, warmup=1)
        lib16_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh16, kh16, vh16, enable_gqa=True, **sdpa))
        b16_ms, b16_by, tc16_ms = bound_bf16(nbytes / 2, flops / 2,
                                             flops / 2, q_bf16=True,
                                             kv_bf16=True)
        print(f"flash {c['name']} bf16 (q, k and v): kernel {ms16:.4f} ms "
              f"per eager call, {g16_ms:.4f} ms as a graph replay "
              f"({flops / g16_ms / 1e9:.2f} TFLOP/s); bound {b16_ms:.4f} ms "
              f"by {b16_by} ({b16_ms / g16_ms:.1%} of it as a replay), bf16 "
              f"tensor-core peak {tc16_ms:.4f} ms; ops.flash_attention "
              f"{op16_ms:.4f} ms; plain {plain16_ms:.4f} ms, sdpa bf16 "
              f"{lib16_ms:.4f} ms")
        timing = dict(ms=ms, graph_ms=g_ms, op_ms=op_ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by, bound_3xtf32_ms=tc_ms,
                      library_ms=lib_ms, bf16_ms=ms16, bf16_graph_ms=g16_ms,
                      bf16_op_ms=op16_ms, bf16_plain_ms=plain16_ms,
                      bf16_bound_ms=b16_ms, bf16_bound_by=b16_by,
                      bf16_bound_bf16tc_ms=tc16_ms,
                      bf16_library_ms=lib16_ms)
        if row is None:
            row = dict(name="flash_fwd_kernel", route="cuda", source=FA_CU,
                       replaces=f"{FA_PY}:93", launches=0, bf16_launches=0,
                       **timing, variants=[])
        else:
            row["variants"].append(dict(name=c["name"], **timing))
        del q, k, v, qh, kh, vh, got, q16, k16, v16, qh16, kh16, vh16
        torch.cuda.empty_cache()
    row["max_abs_err"] = err
    row["bf16_max_abs_err"] = pair_err
    return row


# ----------------------------------------------------------- engine phase
PROMPT_LENS = (300, 2500, 777, 1503, 1029, 451, 2085, 1234)
NEW_TOKENS = 16
ENTRY_POINTS = ("prefill", "prefill_chunk", "decode_step", "ragged_step")


# the paged decode keys the script serves, each tuned once at the decode
# shape of the run that serves it: (what, KV heads, head_dim, bs, batch,
# query heads per KV head, blocks a sequence, pool dtypes).  granite-3-8b,
# Jamba and InternVL2 share (8, 128, 128) (the key has no G and no batch,
# in the reference too): tuned at the engine's decode shape (max_seq_len
# 2560), over an f32 pool and, for the bf16 engine phase, a bf16 one
TUNED = (("granite-3-8b, Jamba, InternVL2", KV, HD, BS, 8, G, 2560 // BS,
          ("float32", "bfloat16")),
         ("whisper-small", 12, 64, BS, 2, 1, 2, ("float32",)))


def tuner_phase(torch) -> dict:
    """``autotune`` every key of TUNED in each of its pool dtypes; returns
    {key: depth}."""
    from repro_torch.kernels.paged_attention import autotune
    depths = {}
    for what, kv, hd, bs, batch, group, n_blocks, dtypes in TUNED:
        for name in dtypes:
            dtype = getattr(torch, name)
            t0 = time.perf_counter()
            tuning = autotune.autotune(kv, hd, bs, n_blocks, batch=batch,
                                       group=group, device=DEVICE,
                                       dtype=dtype)
            ms = ", ".join(f"depth {d} {v:.4f} ms" for d, v in
                           sorted(tuning.ms.items()))
            print(f"tuner ({kv}, {hd}, {bs}, {name}) for {what} at B "
                  f"{batch}, G {group}, {n_blocks} blocks a sequence: {ms} "
                  f"(median of 20 CUDA-event timed calls each); winner "
                  f"depth {tuning.buffer_depth}; "
                  f"{time.perf_counter() - t0:.2f} s; card {card_line()}")
            depths[autotune.tuning_key(kv, hd, bs, dtype=dtype)] = \
                tuning.buffer_depth
    return depths


def serve(torch, cfg, params, *, prompt_lens, page_impl: str, seed: int,
          tops: dict | None = None, force: dict | None = None,
          picks: dict | None = None, **engine_kw):
    """One engine run; returns tokens by request, the snapshot, decode
    steps, seconds, each (request, token index)'s top-2 logit margin and
    the seconds of the device timeline spanned by each model entry point
    (CUDA events around each call, which neither block the host nor
    change the run; the rest is the device waiting on host work between
    calls).  ``tops``, if given, gets each (request, token index)'s top
    logit.  With ``force`` ({request: tokens}, another run's) the engine
    takes those tokens (teacher forcing: each step's logits row becomes
    one-hot at the forced token after it is read), and ``picks`` gets
    each (request, token index)'s own greedy token, so every token of a
    run is compared in the same context, not only up to a first
    divergence."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, params, config=EngineConfig(
        max_batch=8, admission="fcfs", page_impl=page_impl, device=DEVICE,
        **engine_kw))
    rng = np.random.RandomState(seed)
    for i, n in enumerate(prompt_lens):
        eng.submit(rng.randint(1, cfg.vocab, size=n),
                   max_new_tokens=NEW_TOKENS, stream=f"s{i % 2}",
                   group_id=i % 2 + 1)
    margins: dict = {}
    bad: list = []

    def record(logits, slots):
        top = torch.topk(logits.float(), 2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).cpu().tolist()
        best = top[:, 0].cpu().tolist()
        finite = torch.isfinite(logits).all(dim=-1).cpu().tolist()
        own = logits.argmax(dim=-1).cpu().tolist()
        for slot, r in slots.items():
            margins[(r.rid, len(r.generated))] = gap[slot]
            if tops is not None:
                tops[(r.rid, len(r.generated))] = best[slot]
            if picks is not None:
                picks[(r.rid, len(r.generated))] = own[slot]
            if not finite[slot]:
                bad.append((r.rid, len(r.generated)))
        if force is not None and slots:
            rows = torch.tensor(list(slots), device=logits.device)
            toks = torch.tensor([force[r.rid][len(r.generated)]
                                 for r in slots.values()],
                                device=logits.device)
            logits[rows] = 0.0
            logits[rows, toks] = 1.0

    events: dict = {name: [] for name in ENTRY_POINTS}

    def timed(name):
        fn = getattr(tfm, name)

        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events[name].append((start, end))
            return out
        return call

    run = {name: timed(name) for name in events}

    def decode(*a, **k):
        lg, st = run["decode_step"](*a, **k)
        record(lg, {s: r for s, r in eng.sched.running.items()
                    if r.state == "running"})
        return lg, st

    def ragged_step(*a, **k):
        lg, st = run["ragged_step"](*a, **k)
        record(lg, dict(eng.sched.running))
        return lg, st

    with mock.patch.object(tfm, "decode_step", decode), \
            mock.patch.object(tfm, "ragged_step", ragged_step), \
            mock.patch.object(tfm, "prefill_chunk", run["prefill_chunk"]), \
            mock.patch.object(tfm, "prefill", run["prefill"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while not eng.sched.idle and eng.steps < 10_000:
            eng.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if bad:
        fail(f"non-finite logits at {bad[:4]}")
    spent = {name: sum(s.elapsed_time(e) for s, e in pairs) / 1e3
             for name, pairs in events.items()}
    toks = {r.rid: list(map(int, r.generated)) for r in eng.sched.done}
    if len(toks) != len(prompt_lens):
        fail(f"{len(toks)} of {len(prompt_lens)} requests completed")
    out = (toks, eng.metrics.snapshot(), eng.decode_steps, secs, margins,
           spent)
    del eng                   # the engine's bus holds reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kernel_modules() -> list:
    """The wrapper module of every CUDA kernel (each has LAUNCHES)."""
    import importlib
    return [importlib.import_module(f"repro_torch.kernels.{k}.{k}")
            for k in ("paged_attention", "mla_attention", "mamba_scan",
                      "rwkv6_scan", "flash_attention")]


def reset_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def launch_counts() -> dict:
    """Every kernel's launches since :func:`reset_launches`."""
    return {k: v for mod in kernel_modules() for k, v in mod.LAUNCHES.items()}


# near-ties, by the rule of the run's weights: "f32", an oracle top-2
# logit margin below F32_TIE; "bf16", at most BF16_TIE * max(1, |top
# logit|) (the reference's bf16 kernel tolerance, tests/test_kernels.py:49,
# applied to the logit; one bf16 ulp at a logit near 1 is 7.8e-3)
F32_TIE = 1e-3
BF16_TIE = 3e-2


def near_tie(margin, top, rule: str) -> bool:
    if margin is None:
        return False
    if rule == "f32":
        return margin < F32_TIE
    return top is not None and margin <= BF16_TIE * max(1.0, abs(top))


def check_tokens(got, want, margins, what: str) -> None:
    """Greedy tokens equal the oracle's but where a request first diverges
    at an f32 near-tie.  Prints every divergence."""
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        i = next(j for j in range(len(b)) if j >= len(a) or a[j] != b[j])
        m = margins.get((rid, i))
        print(f"{what}: request {rid} diverges at token {i} "
              f"(kernel {a[i] if i < len(a) else None}, oracle {b[i]}); "
              f"oracle top-2 margin {m}")
        if not near_tie(m, None, "f32"):
            fail(f"{what}: request {rid} diverges at token {i} with oracle "
                 f"margin {m} (not a near-tie)")


def check_picks(picks, want, margins, tops, what: str, rule: str) -> None:
    """Teacher-forced comparison (``serve(force=want)``): at every token
    of every request the kernel run's own greedy token, in the oracle's
    context, equals the oracle's, but at a near-tie under ``rule``.
    Prints each disagreement and how many tokens and requests were
    compared."""
    n = bad = 0
    touched = set()
    for rid in sorted(want):
        for i, tok in enumerate(want[rid]):
            n += 1
            got = picks.get((rid, i))
            if got == tok:
                continue
            bad += 1
            touched.add(rid)
            m, top = margins.get((rid, i)), tops.get((rid, i))
            print(f"{what}: request {rid} token {i}: kernel {got}, oracle "
                  f"{tok}; oracle top-2 margin {m}, top logit {top}")
            if not near_tie(m, top, rule):
                fail(f"{what}: request {rid} token {i} differs at oracle "
                     f"margin {m}, top logit {top} (not a near-tie under the "
                     f"{rule} rule)")
    print(f"{what}: {n} tokens of {len(want)} requests compared in the "
          f"oracle's context; {bad} differ, in {len(touched)} requests, "
          f"each at a near-tie ({rule} rule)")


def engine_runs(torch, cfg, params, seed: int, *, paths, pool_dtype,
                what: str, rule: str = "f32") -> dict:
    """Serve PROMPT_LENS through each of ``paths`` ("chunked": decode
    through the paged decode kernel; "ragged": the ragged kernel) from a
    ``pool_dtype`` pool, each against the same engine over
    ``page_impl="ref"``: the kernel run, forced to the oracle's tokens,
    picks the oracle's token at every position but at a near-tie under
    ``rule`` (that of the weights' dtype); the path's launches = layers x
    steps and no other kernel's.  Returns {path: (kernel, launches,
    kernel tokens/s, oracle tokens/s)}."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    out = {}
    for path in paths:
        ragged = path == "ragged"
        kernel = "ragged" if ragged else "paged_decode"
        kw = dict(prompt_lens=PROMPT_LENS, seed=seed, num_blocks=256,
                  max_seq_len=2560, chunked_prefill=True, prefill_chunk=2,
                  ragged_kernel=ragged, dtype=pool_dtype)
        # CUDA events around each call of the path's kernel wrapper: the
        # stream time its calls span in the run (two event records per call)
        op = "ragged_fused_fwd" if ragged else "paged_attention_fused_fwd"
        tops: dict = {}
        ref_toks, _, _, ref_secs, margins, _ = serve(
            torch, cfg, params, page_impl="ref", tops=tops, **kw)
        picks: dict = {}
        reset_launches()
        with timed_calls(torch, pa_ops, op) as calls:
            toks, snap, decode_steps, secs, _, spent = serve(
                torch, cfg, params, page_impl="kernel", force=ref_toks,
                picks=picks, **kw)
        counts = launch_counts()
        steps = (snap["engine.kernel.ragged_steps"] if ragged
                 else decode_steps)
        want = cfg.n_layers * steps
        if counts[kernel] != want or any(
                v for k, v in counts.items() if k != kernel):
            fail(f"{what} {path} path launches {counts}, expected {kernel} "
                 f"= {cfg.n_layers} layers x {steps} steps = {want}")
        if ragged and snap["engine.kernel.kernel_calls"] != want:
            fail(f"{what} ragged kernel_calls "
                 f"{snap['engine.kernel.kernel_calls']} != {want}")
        if snap["engine.prefill_chunk_traces"] != 1:
            fail(f"{what} {path}: {snap['engine.prefill_chunk_traces']} "
                 f"chunk shape signatures, expected 1")
        if toks != ref_toks:
            fail(f"{what} {path}: the forced run did not serve the oracle's "
                 f"tokens")
        check_picks(picks, ref_toks, margins, tops, f"{what} {path}", rule)
        n = sum(len(t) for t in toks.values())
        out[path] = (kernel, counts[kernel], n / secs, n / ref_secs)
        print(f"engine {what} {path}: {n} tokens, kernel {n / secs:.2f} "
              f"tokens/s ({secs:.2f} s), oracle {n / ref_secs:.2f} tokens/s "
              f"({ref_secs:.2f} s); {kernel} launches {counts[kernel]} = "
              f"{cfg.n_layers} x {steps} steps; tokens match the oracle "
              f"({rule} near-tie rule, teacher-forced)")
        split = ", ".join(f"{k} {v:.2f} s" for k, v in spent.items() if v)
        print(f"engine {what} {path} kernel run, device time spanned: "
              f"{split}, rest {secs - sum(spent.values()):.2f} s")
        print(f"engine {what} {path} kernel run: {span_line(calls, op)}")
    return out


def granite_params(torch, cfg, seed: int, dtype):
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=DEVICE).manual_seed(seed),
        device=DEVICE, dtype=dtype)
    torch.cuda.synchronize()
    print(f"granite-3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{tfm.param_count(params) / 1e9:.3f} B params "
          f"{str(dtype).removeprefix('torch.')}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    return params


def engine_phase(torch, layers: int, seed: int) -> dict:
    """granite-3-8b (``layers`` of 40) in f32 through the chunked and the
    ragged path; returns engine_runs' result."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-3-8b")
    if layers != cfg.n_layers:
        cfg = cfg.with_(n_layers=layers)
    params = granite_params(torch, cfg, seed, torch.float32)
    return engine_runs(torch, cfg, params, seed, paths=("chunked", "ragged"),
                       pool_dtype=torch.float32, what="f32")


# the mixed-dtype run: granite cut to this many layers, f32 params (so f32
# queries and logits) over a bf16 pool, the chunked path
MIXED_LAYERS = 8


def bf16_engine_phase(torch, layers: int, seed: int, f32_runs: dict) -> dict:
    """granite-3-8b (``layers`` of 40) with bf16 params over a bf16 pool
    through the chunked and the ragged path under the bf16 near-tie rule,
    then cut to MIXED_LAYERS with f32 params over a bf16 pool, chunked,
    under the f32 rule; prints each path's tokens/s beside the f32
    phase's.  Returns {run: engine_runs' entry}."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-3-8b")
    if layers != cfg.n_layers:
        cfg = cfg.with_(n_layers=layers)
    params = granite_params(torch, cfg, seed, torch.bfloat16)
    runs = engine_runs(torch, cfg, params, seed, paths=("chunked", "ragged"),
                       pool_dtype=torch.bfloat16, what="bf16",
                       rule="bf16")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    for path, (_, _, tps, ref_tps) in runs.items():
        f32_tps, f32_ref = f32_runs[path][2], f32_runs[path][3]
        print(f"granite-3-8b {cfg.n_layers} layers {path}: bf16 {tps:.2f} "
              f"tokens/s (oracle {ref_tps:.2f}), f32 {f32_tps:.2f} tokens/s "
              f"(oracle {f32_ref:.2f}); card {card}")
    mixed = cut_config("granite-3-8b", MIXED_LAYERS)
    params = granite_params(torch, mixed, seed, torch.float32)
    mixed_runs = engine_runs(torch, mixed, params, seed, paths=("chunked",),
                             pool_dtype=torch.bfloat16,
                             what="f32 params over a bf16 pool")
    runs.update({f"mixed {k}": v for k, v in mixed_runs.items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# DeepSeek-V2 cut to 4 layers: layer 0 dense, 1-3 MoE (13.3 B params,
# 53 GB in f32 — the most that leaves room on an 80 GB card; 26.6 GB in
# bf16)
DS_LAYERS = 4
DS_PROMPT_LENS = (200, 1500, 777, 1029, 451, 1234)


def deepseek_phase(torch, seed: int, dtype) -> tuple[int, float, float]:
    """Serve DeepSeek-V2 (MLA + MoE) through monolithic prefill and paged
    MLA decode with ``dtype`` params over a ``dtype`` latent pool, the
    kernel run teacher-forced against the ``page_impl="ref"`` oracle (run
    first) under the near-tie rule of ``dtype``; returns the MLA kernel's
    launches on the kernel run and the two runs' tokens/s."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mla_attention import ops as mla_ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    L = DS_LAYERS
    name = str(dtype).removeprefix("torch.")
    rule = "f32" if dtype == torch.float32 else "bf16"
    cfg = get_config("deepseek-v2-236b").with_(
        n_layers=L, mixers=("mla",) * L, ffns=("dense",) + ("moe",) * (L - 1))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)
    params = tfm.init_params(cfg, generator=gen, device=DEVICE, dtype=dtype)
    torch.cuda.synchronize()
    n_params = tfm.param_count(params)
    es = torch.empty((), dtype=dtype).element_size()
    print(f"deepseek-v2-236b: {L} of 60 layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, kv_lora {cfg.mla.kv_lora_rank}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
          f"{n_params / 1e9:.3f} B params ({n_params * es / 1e9:.1f} GB "
          f"{name}), made in {time.perf_counter() - t0:.1f} s")
    kw = dict(prompt_lens=DS_PROMPT_LENS, seed=seed, num_blocks=128,
              max_seq_len=2048, dtype=dtype)
    tops: dict = {}
    ref_toks, _, _, ref_secs, margins, ref_spent = serve(
        torch, cfg, params, page_impl="ref", tops=tops, **kw)
    picks: dict = {}
    reset_launches()
    with timed_calls(torch, mla_ops, "mla_paged_ctx_fwd") as calls:
        toks, snap, decode_steps, secs, _, spent = serve(
            torch, cfg, params, page_impl="kernel", force=ref_toks,
            picks=picks, **kw)
    counts = launch_counts()
    want = L * decode_steps
    what = f"deepseek-v2 {name}"
    if counts["mla_ctx"] != want or any(
            v for k, v in counts.items() if k != "mla_ctx"):
        fail(f"{what} launches {counts}, expected mla_ctx = {L} layers x "
             f"{decode_steps} decode steps = {want}")
    if toks != ref_toks:
        fail(f"{what}: the forced run did not serve the oracle's tokens")
    check_picks(picks, ref_toks, margins, tops, what, rule)
    n = sum(len(t) for t in toks.values())
    print(f"engine {what}: {n} tokens, kernel {n / secs:.2f} tokens/s "
          f"({secs:.2f} s), oracle {n / ref_secs:.2f} tokens/s "
          f"({ref_secs:.2f} s); mla_ctx launches {counts['mla_ctx']} = {L} x "
          f"{decode_steps} decode steps; {snap['engine.prefill_traces']} "
          f"prefill shapes; tokens match the oracle ({rule} near-tie rule, "
          f"teacher-forced); card {card_line()}")
    print(f"engine {what} kernel run: "
          f"{span_line(calls, 'mla_paged_ctx_fwd')}")
    for run, sp, total in (("kernel", spent, secs),
                           ("oracle", ref_spent, ref_secs)):
        split = ", ".join(f"{k} {v:.3f} s" for k, v in sp.items() if v)
        print(f"engine {what} {run} run, device time spanned: {split}, "
              f"rest {total - sum(sp.values()):.3f} s")
    if dtype == torch.float32:
        # the reference's dispatch runs every expert at capacity >= 4 per
        # step
        ffn = tfm.layer_params(params, cfg, 1)["ffn"]
        x = torch.randn(8, 1, cfg.d_model, generator=gen, device=DEVICE)
        moe_ms = time_ms(torch, lambda: moe_mod.moe_ffn(ffn, x, cfg),
                         reps=10)
        mo = cfg.moe
        w_bytes = 3 * mo.num_experts * cfg.d_model * mo.d_expert * 4
        print(f"moe_ffn at decode shape (8 tokens, {mo.num_experts} experts "
              f"x capacity "
              f"{moe_mod.capacity_for(8, mo.top_k, mo.num_experts)}): "
              f"{moe_ms:.3f} ms, {w_bytes / 1e9:.2f} GB of routed-expert "
              f"weights read, {w_bytes / moe_ms / 1e9:.2f} TB/s")
    print(f"deepseek-v2 {name}: peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts["mla_ctx"], n / secs, n / ref_secs


# ------------------------------------------------- hybrid forward phases
# Jamba-v0.1 at its published widths cut to one period of 8 layers (7 Mamba,
# attention at offset 4, MoE on the odd layers: 13.3 B params, 53.2 GB f32);
# RWKV-6-7B at full width and depth (32 layers, 8.9 B params, 35.5 GB f32)
HYBRID_LAYERS = {"jamba-v0.1-52b": 8, "rwkv6-7b": 32}
HYBRID_B, HYBRID_PROMPT, HYBRID_NEW = 2, 1000, 16
LOSS_SHAPE = (2, 1024)
LOSS_RTOL = 1e-4
ATTN_TOL = 1e-4      # attn_layer adds o @ wo: a 4096-long f32 sum per output
# bf16 params and activations: the reference's bf16 flash-kernel tolerance
# (tests/test_kernels.py:49), scaled by max(1, max|want|)
ATTN_BF16_TOL = 3e-2


def hybrid_config(name: str):
    return cut_config(name, HYBRID_LAYERS[name])


def greedy(torch, cfg, params, prompts, *, impl: str, page_impl: str,
           **prefill_kw):
    """``prefill(impl, **prefill_kw)`` (frames or patches) then HYBRID_NEW
    greedy ``decode_step``s; returns tokens by batch row, each (row, token
    index)'s top-2 logit margin, the launches of the prefill and of the
    decode steps, and their seconds."""
    from repro_torch.models import transformer as tfm
    B, S = prompts.shape
    if "patches" in prefill_kw:
        S += prefill_kw["patches"].shape[1]
    st = tfm.init_decode_state(cfg, B, S + HYBRID_NEW + 1,
                               dtype=torch.float32, device=DEVICE)
    toks, margins, launches, secs = [], {}, [], []

    def take(lg):
        top = torch.topk(lg, 2, dim=-1).values
        for b, gap in enumerate((top[:, 0] - top[:, 1]).tolist()):
            margins[(b, len(toks))] = gap
        if not torch.isfinite(lg).all():
            fail(f"{cfg.name}: non-finite logits at token {len(toks)}")
        tok = lg.argmax(-1).to(torch.int32)
        toks.append(tok.tolist())
        return tok

    for phase in ("prefill", "decode"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if phase == "prefill":
            lg, st = tfm.prefill(params, cfg, prompts, st, impl=impl,
                                 **prefill_kw)
            if not (st["lengths"] == S).all():
                fail(f"{cfg.name}: prefill lengths {st['lengths'].tolist()}"
                     f", expected {S}")
            tok = take(lg)
        else:
            for _ in range(HYBRID_NEW):
                lg, st = tfm.decode_step(params, cfg, st, tok,
                                         page_impl=page_impl)
                tok = take(lg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(launch_counts())
    by_row = {b: [t[b] for t in toks] for b in range(B)}
    return by_row, margins, launches, secs


def expect_launches(counts: dict, want: dict, what: str) -> None:
    got = {k: v for k, v in counts.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        fail(f"{what}: kernel launches {got}, expected {want}")


def attn_bf16_check(torch, name: str, layer: int, lp: dict, x, pos,
                    cfg) -> int:
    """``attn_layer(impl="kernel")`` on bf16 params and activations (one
    flash launch, q, k and v in bf16) against ``impl="chunked"`` at the
    same dtype, within ATTN_BF16_TOL x max(1, max|want|); returns the
    flash launches (1)."""
    from repro_torch.models import attention as attn_mod
    reset_launches()
    got = attn_mod.attn_layer(lp, x, pos, cfg, impl="kernel")
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {"flash_attention": 1},
                    f"{name} attn_layer bf16")
    want = attn_mod.attn_layer(lp, x, pos, cfg, impl="chunked")
    if got.dtype != torch.bfloat16 or not torch.isfinite(got).all():
        fail(f"{name} attn_layer bf16: dtype {got.dtype} or not finite")
    e, sc = scaled_err(got.float(), want.float())
    if not math.isfinite(e) or e > ATTN_BF16_TOL * sc:
        fail(f"{name} attn_layer bf16 layer {layer}: max abs err {e} > "
             f"{ATTN_BF16_TOL} x {sc:.3g}")
    print(f"{name} attn_layer(impl='kernel') layer {layer} in bf16 on "
          f"{tuple(x.shape)} (window {cfg.attn.window}): max abs err vs "
          f"chunked {e:.3g} (limit {ATTN_BF16_TOL * sc:.3g}), one flash "
          f"launch")
    return 1


def danube_attn_phase(torch, seed: int) -> int:
    """h2o-danube-3-4b's layer 0 at its published widths (32 heads, 8 KV
    heads of 120, window 4096) in bf16 on (1, 6144, 3840): see
    :func:`attn_bf16_check`; returns the flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    cfg = get_config("h2o-danube-3-4b")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 6)
    lp = attn_mod.init_attn(cfg, generator=gen, device=DEVICE,
                            dtype=torch.bfloat16)
    S = FLASH_CASES[1]["S"]
    x = torch.randn(1, S, cfg.d_model, generator=gen,
                    device=DEVICE).bfloat16()
    pos = torch.arange(S, device=DEVICE)[None]
    n = attn_bf16_check(torch, "h2o-danube-3-4b", 0, lp, x, pos, cfg)
    del lp, x
    torch.cuda.empty_cache()
    return n


def hybrid_phase(torch, name: str, seed: int) -> dict:
    """Forward of a hybrid family through the kernels against the
    ``impl="chunked"`` / ``page_impl="ref"`` oracle: prefill and greedy
    decode (tokens equal but for near-ties), ``loss_fn`` (relative 1e-4),
    and for Jamba ``attn_layer(impl="kernel")`` (flash attention) on layer
    4 against ``impl="chunked"``, in f32 and in bf16.  Returns each
    kernel's launches on the kernel runs (the bf16 flash launch also
    under "flash_attention bf16")."""
    import importlib

    import numpy as np
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tfm
    cfg = hybrid_config(name)
    scan = "mamba_scan" if "mamba" in cfg.mixers else "rwkv6_scan"
    n_scan = sum(m in ("mamba", "rwkv6") for m in cfg.mixers)
    n_attn = len(tfm.attn_layer_ids(cfg))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    params = tfm.init_params(cfg, generator=gen, device=DEVICE,
                             dtype=torch.float32)
    torch.cuda.synchronize()
    n_params = tfm.param_count(params)
    print(f"{name}: {cfg.n_layers} layers ({n_scan} {scan.split('_')[0]}, "
          f"{n_attn} attention, {cfg.ffns.count('moe')} MoE), d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params "
          f"({n_params * 4 / 1e9:.1f} GB f32), made in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed)
    prompts = torch.as_tensor(rng.randint(1, cfg.vocab, (HYBRID_B,
                                                         HYBRID_PROMPT)),
                              dtype=torch.int32, device=DEVICE)
    launches = {scan: 0, "paged_decode": 0, "flash_attention": 0}
    scan_ops = importlib.import_module(f"repro_torch.kernels.{scan}.ops")
    with torch.no_grad():
        with timed_calls(torch, scan_ops, scan) as calls:
            toks, _, (pre, dec), secs = greedy(
                torch, cfg, params, prompts, impl="kernel",
                page_impl="kernel")
        print(f"{name} kernel prefill: {span_line(calls, f'ops.{scan}')}")
        expect_launches(pre, {scan: n_scan}, f"{name} prefill")
        expect_launches(dec, {"paged_decode": n_attn * HYBRID_NEW},
                        f"{name} decode")
        launches[scan] += pre[scan]
        launches["paged_decode"] += dec["paged_decode"]
        want, margins, _, ref_secs = greedy(torch, cfg, params, prompts,
                                            impl="chunked", page_impl="ref")
        check_tokens(toks, want, margins, name)
        n = HYBRID_B * (HYBRID_NEW + 1)
        print(f"{name} prefill {HYBRID_B}x{HYBRID_PROMPT} + {HYBRID_NEW} "
              f"greedy decode steps: {n} tokens equal the oracle; kernel "
              f"prefill {secs[0]:.3f} s, decode {secs[1]:.3f} s; oracle "
              f"prefill {ref_secs[0]:.3f} s, decode {ref_secs[1]:.3f} s; "
              f"launches prefill {pre[scan]} {scan}, decode "
              f"{dec['paged_decode']} paged_decode")

        tokens = torch.as_tensor(rng.randint(1, cfg.vocab, LOSS_SHAPE),
                                 dtype=torch.int32, device=DEVICE)
        labels = torch.roll(tokens, -1, dims=1)
        labels[:, -1] = -100
        batch = {"tokens": tokens, "labels": labels}
        loss = {}
        for impl in ("kernel", "chunked"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with timed_calls(torch, scan_ops, scan) as calls:
                loss[impl] = tfm.loss_fn(params, cfg, batch, impl=impl).item()
            loss[impl + " s"] = time.perf_counter() - t0
            if impl == "kernel":
                print(f"{name} kernel loss_fn: "
                      f"{span_line(calls, f'ops.{scan}')}")
                counts = launch_counts()
                expect_launches(counts, {scan: n_scan}, f"{name} loss_fn")
                launches[scan] += counts[scan]
        rel = abs(loss["kernel"] - loss["chunked"]) / abs(loss["chunked"])
        if not math.isfinite(rel) or rel > LOSS_RTOL:
            fail(f"{name} loss_fn: kernel {loss['kernel']} vs chunked "
                 f"{loss['chunked']} (relative {rel:.3g} > {LOSS_RTOL})")
        print(f"{name} loss_fn on {LOSS_SHAPE[0]}x{LOSS_SHAPE[1]}: kernel "
              f"{loss['kernel']:.6f} ({loss['kernel s']:.3f} s), chunked "
              f"{loss['chunked']:.6f} ({loss['chunked s']:.3f} s), relative "
              f"difference {rel:.3g}")

        for i in tfm.attn_layer_ids(cfg)[:1]:
            lp = tfm.layer_params(params, cfg, i)["mix"]
            S = FLASH_CASES[0]["S"]
            x = torch.randn(1, S, cfg.d_model, generator=gen, device=DEVICE)
            pos = torch.arange(S, device=DEVICE)[None]
            reset_launches()
            got = attn_mod.attn_layer(lp, x, pos, cfg, impl="kernel")
            torch.cuda.synchronize()
            expect_launches(launch_counts(), {"flash_attention": 1},
                            f"{name} attn_layer")
            launches["flash_attention"] += 1
            want_o = attn_mod.attn_layer(lp, x, pos, cfg, impl="chunked")
            e, sc = scaled_err(got, want_o)
            if not math.isfinite(e) or e > ATTN_TOL * sc:
                fail(f"{name} attn_layer layer {i}: max abs err {e} > "
                     f"{ATTN_TOL} x {sc:.3g}")
            print(f"{name} attn_layer(impl='kernel') layer {i} on (1, {S}, "
                  f"{cfg.d_model}): max abs err vs chunked {e:.3g}, one "
                  f"flash launch")
            n16 = attn_bf16_check(
                torch, name, i, {k: v.bfloat16() for k, v in lp.items()},
                x.bfloat16(), pos, cfg)
            launches["flash_attention"] += n16
            launches["flash_attention bf16"] = n16
    print(f"{name}: peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------ encoder-decoder and vision prefix
# whisper-small whole (12 decoder + 12 encoder layers over 1500 frames,
# MHA: 12 KV heads of 64, 0.340 B params); InternVL2-26B at its published
# widths cut to 16 of 48 layers (KV 8, G 6, hd 128; 7.418 B params, 29.7
# GB f32: all 48 would take 79.6 GB and leave no room for the pools)
ENCDEC_PROMPT = (2, 200)
ENCDEC_LOSS = (2, 448)
VL_LAYERS = 16
VL_PROMPT = (2, 300)
VL_LOSS = (2, 256)
VL_ENGINE_LENS = (300, 1500, 777, 1029)


def made_line(torch, cfg, params, t0: float, what: str) -> None:
    from repro_torch.models import transformer as tfm
    torch.cuda.synchronize()
    n = tfm.param_count(params)
    print(f"{cfg.name}: {what}, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"(KV {cfg.n_kv_heads}, hd {cfg.head_dim}), {n / 1e9:.3f} B params "
          f"({n * 4 / 1e9:.2f} GB f32), made in "
          f"{time.perf_counter() - t0:.1f} s")


def decode_check(torch, cfg, params, prompts, **prefill_kw) -> int:
    """``prefill`` (with frames or patches, launching no kernel) and
    HYBRID_NEW greedy ``decode_step``s through the paged decode kernel
    against ``page_impl="ref"`` (tokens equal but for near-ties); returns
    the kernel's launches."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import transformer as tfm
    n_attn = len(tfm.attn_layer_ids(cfg))
    op = "paged_attention_fused_fwd"
    with timed_calls(torch, pa_ops, op) as calls:
        toks, _, (pre, dec), secs = greedy(
            torch, cfg, params, prompts, impl="chunked", page_impl="kernel",
            **prefill_kw)
    expect_launches(pre, {}, f"{cfg.name} prefill")
    expect_launches(dec, {"paged_decode": n_attn * HYBRID_NEW},
                    f"{cfg.name} decode")
    want, margins, _, ref_secs = greedy(
        torch, cfg, params, prompts, impl="chunked", page_impl="ref",
        **prefill_kw)
    check_tokens(toks, want, margins, cfg.name)
    B, S = prompts.shape
    extra = "".join(f" + {k} {tuple(v.shape)}" for k, v in prefill_kw.items())
    n = B * HYBRID_NEW
    print(f"{cfg.name} prefill {B}x{S}{extra}, {HYBRID_NEW} greedy decode "
          f"steps: {B * (HYBRID_NEW + 1)} tokens equal the oracle; kernel "
          f"prefill {secs[0]:.3f} s, decode {secs[1]:.3f} s "
          f"({n / secs[1]:.2f} tokens/s); oracle prefill {ref_secs[0]:.3f} "
          f"s, decode {ref_secs[1]:.3f} s ({n / ref_secs[1]:.2f} tokens/s); "
          f"paged_decode launches {dec['paged_decode']} = {n_attn} layers x "
          f"{HYBRID_NEW} steps")
    print(f"{cfg.name} kernel decode: {span_line(calls, op)}")
    return dec["paged_decode"]


def loss_check(torch, cfg, params, batch: dict) -> None:
    """``loss_fn`` with ``impl="chunked"`` against ``"direct"`` attention
    (relative LOSS_RTOL); neither launches a kernel."""
    from repro_torch.models import transformer as tfm
    loss = {}
    for impl in ("chunked", "direct"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss[impl] = tfm.loss_fn(params, cfg, batch, impl=impl).item()
        loss[impl + " s"] = time.perf_counter() - t0
        expect_launches(launch_counts(), {}, f"{cfg.name} loss_fn({impl})")
    rel = abs(loss["chunked"] - loss["direct"]) / abs(loss["direct"])
    if not math.isfinite(rel) or rel > LOSS_RTOL:
        fail(f"{cfg.name} loss_fn: chunked {loss['chunked']} vs direct "
             f"{loss['direct']} (relative {rel:.3g} > {LOSS_RTOL})")
    inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()
                       if k != "labels")
    print(f"{cfg.name} loss_fn on {inputs}: chunked {loss['chunked']:.6f} "
          f"({loss['chunked s']:.3f} s), direct {loss['direct']:.6f} "
          f"({loss['direct s']:.3f} s), relative difference {rel:.3g}")


def loss_batch(torch, rng, cfg, shape, **inputs) -> dict:
    tokens = torch.as_tensor(rng.randint(1, cfg.vocab, shape),
                             dtype=torch.int32, device=DEVICE)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -100
    return {"tokens": tokens, "labels": labels, **inputs}


def encdec_phase(torch, seed: int) -> int:
    """whisper-small whole: ``prefill(enc_frames=...)`` and greedy decode
    through the paged decode kernel (MHA, one query head a CTA) against
    the oracle, then ``loss_fn`` with frames; returns the decode kernel's
    launches (12 layers x 16 steps)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config("whisper-small")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    params = tfm.init_params(cfg, generator=gen, device=DEVICE,
                             dtype=torch.float32)
    made_line(torch, cfg, params, t0,
              f"{cfg.n_layers} decoder + {cfg.enc_layers} encoder layers "
              f"over {cfg.enc_len} frames")
    rng = np.random.RandomState(seed + 7)
    B, S = ENCDEC_PROMPT
    prompts = torch.as_tensor(rng.randint(1, cfg.vocab, (B, S)),
                              dtype=torch.int32, device=DEVICE)
    frames = torch.randn(B, cfg.enc_len, cfg.d_model, generator=gen,
                         device=DEVICE)
    with torch.no_grad():
        launches = decode_check(torch, cfg, params, prompts,
                                enc_frames=frames)
        loss_check(torch, cfg, params,
                   loss_batch(torch, rng, cfg, ENCDEC_LOSS, frames=frames))
    print(f"{cfg.name}: peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def vision_phase(torch, seed: int) -> dict:
    """InternVL2-26B cut to VL_LAYERS: ``prefill(patches=...)`` of the
    256-token vision prefix plus text, greedy decode through the paged
    decode kernel (G 6) against the oracle, ``loss_fn`` with patches, and
    text traffic through the engine's ragged path (ragged kernel at its
    6-head cap) against the same engine over ``page_impl="ref"``; returns
    each kernel's launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import transformer as tfm
    full = get_config("internvl2-26b")
    L = VL_LAYERS
    cfg = cut_config("internvl2-26b", L)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    params = tfm.init_params(cfg, generator=gen, device=DEVICE,
                             dtype=torch.float32)
    made_line(torch, cfg, params, t0, f"{L} of {full.n_layers} layers, a "
              f"{cfg.prefix_tokens}-token vision prefix")
    rng = np.random.RandomState(seed + 9)
    B, S = VL_PROMPT
    prompts = torch.as_tensor(rng.randint(1, cfg.vocab, (B, S)),
                              dtype=torch.int32, device=DEVICE)
    patches = torch.randn(B, cfg.prefix_tokens, cfg.d_model, generator=gen,
                          device=DEVICE)
    with torch.no_grad():
        launches = {"paged_decode": decode_check(torch, cfg, params, prompts,
                                                 patches=patches)}
        loss_check(torch, cfg, params,
                   loss_batch(torch, rng, cfg, VL_LOSS, patches=patches))
    kw = dict(prompt_lens=VL_ENGINE_LENS, seed=seed, num_blocks=64,
              max_seq_len=1536, chunked_prefill=True, prefill_chunk=2,
              ragged_kernel=True)
    reset_launches()
    with timed_calls(torch, pa_ops, "ragged_fused_fwd") as calls:
        toks, snap, _, secs, _, spent = serve(torch, cfg, params,
                                              page_impl="kernel", **kw)
    counts = launch_counts()
    steps = snap["engine.kernel.ragged_steps"]
    want = L * steps
    if counts["ragged"] != want or any(
            v for k, v in counts.items() if k != "ragged"):
        fail(f"{cfg.name} ragged path launches {counts}, expected ragged = "
             f"{L} layers x {steps} steps = {want}")
    if snap["engine.kernel.kernel_calls"] != want:
        fail(f"{cfg.name} kernel_calls {snap['engine.kernel.kernel_calls']}"
             f" != {want}")
    if snap["engine.prefill_chunk_traces"] != 1:
        fail(f"{cfg.name}: {snap['engine.prefill_chunk_traces']} chunk shape "
             f"signatures, expected 1")
    ref_toks, _, _, ref_secs, margins, _ = serve(torch, cfg, params,
                                                 page_impl="ref", **kw)
    check_tokens(toks, ref_toks, margins, f"{cfg.name} ragged")
    n = sum(len(t) for t in toks.values())
    print(f"engine {cfg.name} ragged (text): {n} tokens, kernel "
          f"{n / secs:.2f} tokens/s ({secs:.2f} s), oracle "
          f"{n / ref_secs:.2f} tokens/s ({ref_secs:.2f} s); ragged launches "
          f"{counts['ragged']} = {L} x {steps} steps; tokens match the oracle")
    split = ", ".join(f"{k} {v:.2f} s" for k, v in spent.items() if v)
    print(f"engine {cfg.name} ragged kernel run, device time spanned: "
          f"{split}, rest {secs - sum(spent.values()):.2f} s")
    print(f"engine {cfg.name} ragged kernel run: "
          f"{span_line(calls, 'ragged_fused_fwd')}")
    launches["ragged"] = counts["ragged"]
    print(f"{cfg.name}: peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ training phase
TRAIN_LAYERS = 8
TRAIN_BATCH = (2, 1024)
TRAIN_STEPS = 3
TRAIN_FWD_RTOL = 1e-6    # (a)'s step-0 loss against the loss_fn forward
TRAIN_RTOL = 1e-4        # (a) against (b): chunked+remat against direct
TRAIN_MB_RTOL = 1e-5     # (c), two microbatches, against (a)'s first step


def train_flops(cfg, B: int, S: int) -> tuple[float, float]:
    """(forward + backward, recompute) FLOP of one chunked + remat step,
    as eager runs it: forward, 2·T per weight of the layers' and the tied
    unembedding's products and 4·B·S²·H·hd per attention layer (every
    chunk is computed, masked or not); backward, twice the products' and
    2.5 times the attention's (the chunked backward's five S² products to
    the forward's two: QKᵀ again, dP, dV, dQ, dK); remat runs each
    block's forward again but for its last product (the FFN's down
    projection: the non-reentrant checkpoint stops once the backward's
    saved tensors are rebuilt), and the loss chunks' unembedding again."""
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    T, L = B * S, cfg.n_layers
    down = 2 * T * F * D
    linear = 2 * T * (D * (H + 2 * KV) * hd + H * hd * D) + 3 * down
    attn = 4 * B * S * S * H * hd
    unembed = 2 * T * cfg.vocab * D
    return (L * (3 * linear + 3.5 * attn) + 3 * unembed,
            L * (linear - down + attn) + unembed)


def leaf_sumsq(torch, params) -> dict:
    """Each reference leaf's sum of squares (a body leaf's over all of
    its blocks), in f64."""
    from repro_torch.bridge import map_leaves
    out: dict = {}
    map_leaves(lambda key, _b, t: out.__setitem__(
        key, out.get(key, 0.0) + t.double().square().sum().item()), params)
    return out


def training_phase(torch, seed: int) -> dict:
    """granite-3-8b at its published widths cut to TRAIN_LAYERS, trained
    from the same random f32 params and fresh AdamW state three ways:
    (a) ``attn_impl="chunked", remat=True`` (the chunked attention's
    autograd Function and checkpointed blocks), (b) ``"direct"`` without
    remat (plain autograd through the O(S²) oracle), (c) (a) with two
    microbatches for one step.  No kernel launches (the kernels are
    forward only).  Returns (a)'s record for phase 11: its first
    TRAIN_MESH_STEPS losses and grad norms, each leaf's sum of squares
    after them, and the memory resident before its first step."""
    from repro_torch.bridge import tree_map
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_loop as ttl
    from repro_torch.training.data import DataConfig, SyntheticLM
    cfg = train_config_of()
    L = TRAIN_LAYERS
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    params0 = tfm.init_params(cfg, generator=gen, device=DEVICE,
                              dtype=torch.float32)
    made_line(torch, cfg, params0, t0, f"{L} of 40 layers")
    B, S = TRAIN_BATCH
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B))
    host = [data.batch(s) for s in range(TRAIN_STEPS)]
    # a step averages its microbatches' mean losses (as the reference
    # does): (c) equals (a) only where each row counts as many labels
    counts = (host[0]["labels"] != -100).sum(axis=1)
    if len(set(counts.tolist())) != 1:
        fail(f"training: rows of batch 0 count {counts} labels; (c) "
             f"against (a) needs equal counts")
    batches = [{k: torch.as_tensor(v, device=DEVICE) for k, v in b.items()}
               for b in host]
    with torch.no_grad():
        forward = tfm.loss_fn(params0, cfg, batches[0]).item()

    sumsq: dict = {}

    def run(what: str, steps: int, **kw):
        tc = ttl.TrainConfig(**kw)
        step = ttl.make_train_step(cfg, tc)
        params = tree_map(torch.clone, params0)
        opt = topt.init_opt_state(params)
        err = torch.zeros((), device=DEVICE)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        out = []
        for s in range(steps):
            t1 = time.perf_counter()
            params, opt, err, m = step(params, opt, err, batches[s])
            loss, gnorm = m["loss"].item(), m["grad_norm"].item()
            torch.cuda.synchronize()
            out.append((loss, gnorm, time.perf_counter() - t1))
            if not kw and s + 1 == TRAIN_MESH_STEPS:    # (a): the oracle
                sumsq.update(leaf_sumsq(torch, params))
        peak = torch.cuda.max_memory_allocated()
        expect_launches(launch_counts(), {}, f"training {what}")
        if not all(math.isfinite(x) for row in out for x in row[:2]):
            fail(f"training {what}: non-finite loss or grad norm {out}")
        return out, (peak, resident)

    a, peak_a = run("(a) chunked+remat", TRAIN_STEPS)
    b, peak_b = run("(b) direct", TRAIN_STEPS, attn_impl="direct",
                    remat=False)
    c, _ = run("(c) 2 microbatches", 1, microbatches=2)

    def rel(x, y):
        return abs(x - y) / abs(y)
    if not rel(a[0][0], forward) <= TRAIN_FWD_RTOL:
        fail(f"training (a) step-0 loss {a[0][0]} vs loss_fn {forward}")
    for s, (ra, rb) in enumerate(zip(a, b)):
        for i, name in enumerate(("loss", "grad_norm")):
            if not rel(ra[i], rb[i]) <= TRAIN_RTOL:
                fail(f"training step {s} {name}: (a) {ra[i]} vs (b) {rb[i]}"
                     f" (relative {rel(ra[i], rb[i]):.3g} > {TRAIN_RTOL})")
    for i, name in enumerate(("loss", "grad_norm")):
        if not rel(c[0][i], a[0][i]) <= TRAIN_MB_RTOL:
            fail(f"training (c) {name} {c[0][i]} vs (a) {a[0][i]} "
                 f"(relative {rel(c[0][i], a[0][i]):.3g} > {TRAIN_MB_RTOL})")
    if not peak_a[0] < peak_b[0]:
        fail(f"training: (a)'s peak {peak_a[0]} is not below (b)'s "
             f"{peak_b[0]}")
    flops, recompute = train_flops(cfg, B, S)
    for name, hist, peak in (("(a) chunked+remat", a, peak_a),
                             ("(b) direct, no remat", b, peak_b),
                             ("(c) 2 microbatches", c, None)):
        secs = [h[2] for h in hist]
        steady = statistics.median(secs[1:]) if len(secs) > 1 else secs[0]
        mem = (f", peak {peak[0] / 1e9:.2f} GB ({peak[1] / 1e9:.2f} GB "
               f"resident before the first step)" if peak else "")
        print(f"{cfg.name} training {name}: losses "
              f"{[round(h[0], 6) for h in hist]}, grad norms "
              f"{[round(h[1], 6) for h in hist]}; seconds per step "
              f"{[round(x, 4) for x in secs]} (steady {steady:.4f} s, "
              f"{B * S / steady:.1f} tokens/s){mem}")
    steady_a = statistics.median([h[2] for h in a[1:]])
    print(f"{cfg.name} training checks: (a) step-0 loss {a[0][0]:.7f} vs "
          f"loss_fn {forward:.7f} (relative {rel(a[0][0], forward):.3g}); "
          f"(a)/(b) worst relative loss "
          f"{max(rel(x[0], y[0]) for x, y in zip(a, b)):.3g}, grad norm "
          f"{max(rel(x[1], y[1]) for x, y in zip(a, b)):.3g}; (c)/(a) "
          f"loss {rel(c[0][0], a[0][0]):.3g}, grad norm "
          f"{rel(c[0][1], a[0][1]):.3g}; peak (a) {peak_a[0] / 1e9:.2f} GB "
          f"< (b) {peak_b[0] / 1e9:.2f} GB; {flops / 1e12:.2f} TFLOP "
          f"forward + "
          f"backward and {recompute / 1e12:.2f} recompute a step, (a) at "
          f"{(flops + recompute) / steady_a / 1e12:.1f} TFLOP/s; card "
          f"{card_line()}")
    del params0
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": [h[0] for h in a[:TRAIN_MESH_STEPS]],
            "grad_norm": [h[1] for h in a[:TRAIN_MESH_STEPS]],
            "sumsq": sumsq, "resident": peak_a[1]}


# phase 10: two ranks on the one GPU over gloo
MESH_RANKS = 2
# granite's depth in (b) and (d): (d)'s (2, 1) decode all-gathers every
# layer's blocks over gloo a step (6.4 GB at 8 layers, about 100 s for its
# 16 steps), the script's longest path, so it runs 4
MESH_LAYERS = 4
MESH_PROMPT = (2, 1000)
MESH_TIMEOUT = 600          # seconds for both ranks, weights and checks
MESH_DIR = ROOT / "build" / "mesh_phase"


def mesh_config():
    return cut_config("granite-3-8b", MESH_LAYERS)


def mesh_params(torch, cfg, seed: int):
    """The same weights in every process: one seeded CUDA generator."""
    from repro_torch.models import transformer as tfm
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    return tfm.init_params(cfg, generator=gen, device=DEVICE,
                           dtype=torch.float32)


def mesh_prompts(torch, cfg, seed: int):
    import numpy as np
    rng = np.random.RandomState(seed + 13)
    return torch.as_tensor(rng.randint(1, cfg.vocab, MESH_PROMPT),
                           dtype=torch.int32, device=DEVICE)


# phase 10 (c) and 11 (c): DeepSeek-MoE-16B at its published widths cut
# to 4 of 28 layers (layer 0 dense, 1-3 MoE: 64 routed experts of 1408,
# top-6, 2 shared; 2.3 B params, 9.1 GB f32), expert-parallel over the
# mesh's model dim
MOE_LAYERS = 4


def moe_mesh_config():
    return cut_config("deepseek-moe-16b", MOE_LAYERS)


def moe_mesh_params(torch, cfg, seed: int):
    """The same weights in every process: one seeded CUDA generator."""
    from repro_torch.models import transformer as tfm
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return tfm.init_params(cfg, generator=gen, device=DEVICE,
                           dtype=torch.float32)


def expert_bytes(cfg, params) -> int:
    """Bytes of the MoE layers' expert leaves (routed and shared) in
    ``params``."""
    from repro_torch.distributed.sharding import EXPERT_DIMS
    from repro_torch.models import transformer as tfm
    return sum(t.numel() * t.element_size() for i in range(cfg.n_layers)
               if cfg.ffns[i] == "moe"
               for k, t in tfm.layer_params(params, cfg, i)["ffn"].items()
               if k in EXPERT_DIMS)


# phase 10 (d): serving from the rank's ``param_specs`` blocks through a
# Layout: (b)'s granite on both meshes, then phase 11 (d)'s three
# tensor-parallel mixers (MIXER_TRAIN's cuts and seeds) on (1, 2)
SERVE_MESHES = ((2, 1), (1, 2))
#: a granite rank's resident memory before prefill, less the f32 leaves
#: param_specs keeps whole on the mesh, at most this share of the leaves
#: it splits: on (2, 1) the tied embedding, P("model", None), is whole on
#: both data ranks (about 0.20 of the 4-layer model's weights), so the
#: whole model's share would be 0.5 + 0.20 / 2 plus the state
SERVE_RESIDENT = 0.55
SERVE_MIXER_MESH = (1, 2)
#: the scan kernels each rank launches in a mixer's prefill(impl="kernel")
#: (on its heads or channels); decode launches none
SERVE_MIXER_LAUNCHES = {"rwkv6-7b": {"rwkv6_scan": 2},
                        "deepseek-v2-236b": {},
                        "jamba-v0.1-52b": {"mamba_scan": 1}}


def serve_runs(seed: int) -> dict:
    """(d)'s runs: name → (mesh, config, its params' maker, oracle key)."""
    runs = {"granite-{}x{}".format(*shape): (
        shape, mesh_config(), lambda torch, c: mesh_params(torch, c, seed),
        "tokens") for shape in SERVE_MESHES}
    for arch, (layers, off) in MIXER_TRAIN.items():
        runs["{}-{}x{}".format(arch, *SERVE_MIXER_MESH)] = (
            SERVE_MIXER_MESH, cut_config(arch, layers),
            lambda torch, c, s=seed + off: moe_mesh_params(torch, c, s),
            arch)
    return runs


def mesh_phase(torch, seed: int) -> tuple[dict, dict]:
    """The single-process ``page_impl="ref"`` oracles of (b), (c) and (d),
    then MESH_RANKS processes of :func:`mesh_rank` on the GPU; fails
    unless both exit 0, their kernel checks hold and their tokens equal
    the oracles'.  Returns (d)'s scan launches on both ranks and rank 0's
    granite serving runs (for phase 12)."""
    import shutil
    from repro_torch.kernels.paged_attention import autotune
    wants = {}
    oracles = [("tokens", mesh_config(), lambda c: mesh_params(torch, c, seed),
                f"{MESH_LAYERS} of 40 layers (the mesh phase's oracle)"),
               ("moe_tokens", moe_mesh_config(),
                lambda c: moe_mesh_params(torch, c, seed + 23),
                f"{MOE_LAYERS} of 28 layers (the expert-parallel oracle)")]
    for name, (_, cfg, make, key) in serve_runs(seed).items():
        if key != "tokens":
            oracles.append((key, cfg, functools.partial(make, torch),
                            f"{cfg.n_layers} layers (the tensor-parallel "
                            f"serving oracle)"))
    for what, cfg, make, layers in oracles:
        t0 = time.perf_counter()
        params = make(cfg)
        made_line(torch, cfg, params, t0, layers)
        with torch.no_grad():
            wants[what] = greedy(torch, cfg, params,
                                 mesh_prompts(torch, cfg, seed),
                                 impl="chunked", page_impl="ref")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    depth = autotune.get_tuning(KV, HD, BS).buffer_depth
    (MESH_DIR / "args.json").write_text(json.dumps(
        {"seed": seed, "depth": depth}))
    t0 = time.perf_counter()
    run_ranks("--mesh-rank", MESH_DIR, MESH_TIMEOUT, "mesh phase")
    secs = time.perf_counter() - t0
    out = [json.loads((MESH_DIR / f"rank_{r}.json").read_text())
           for r in range(MESH_RANKS)]
    runs = serve_runs(seed)
    scans: dict = {}
    for r, res in enumerate(out):
        for line in res["lines"]:
            print(f"mesh rank {r}: {line}")
        for what in ("tokens", "moe_tokens"):
            want, margins, _, _ = wants[what]
            got = {int(b): v for b, v in res[what].items()}
            if got != {int(b): v for b, v in out[0][what].items()}:
                fail(f"mesh rank {r}'s {what} differ from rank 0's")
            check_tokens(got, want, margins, f"mesh rank {r} {what}")
        for name, run in res["serve"].items():
            shape, cfg, _, key = runs[name]
            want, margins, _, _ = wants[key]
            got = {int(b): v for b, v in run["tokens"].items()}
            if got != {int(b): v for b, v in
                       out[0]["serve"][name]["tokens"].items()}:
                fail(f"mesh rank {r}'s {name} tokens differ from rank 0's")
            check_tokens(got, want, margins, f"mesh rank {r} {name}")
            expect_launches(run["launches"][0],
                            SERVE_MIXER_LAUNCHES.get(key, {}),
                            f"mesh rank {r} {name} prefill")
            expect_launches(run["launches"][1], {},
                            f"mesh rank {r} {name} decode")
            for k, n in run["launches"][0].items():
                scans[k] = scans.get(k, 0) + n
            if key == "tokens":
                split, whole = split_bytes(torch, cfg, shape)
                share = (run["resident"] - whole) / split
                if share > SERVE_RESIDENT:
                    fail(f"mesh rank {r} {name}: resident {run['resident']} "
                         f"B less the {whole} B of leaves kept whole is "
                         f"{share:.4f} of the {split} B of leaves split "
                         f"(> {SERVE_RESIDENT})")
                print(f"mesh rank {r} {name}: resident less the leaves kept "
                      f"whole ({whole / 1e9:.3f} GB) {share:.4f} of the "
                      f"leaves param_specs splits ({split / 1e9:.3f} GB)")
    n = MESH_PROMPT[0] * HYBRID_NEW
    oracle = "; ".join(
        f"{name} over the mesh: {MESH_PROMPT[0] * (HYBRID_NEW + 1)} tokens "
        f"equal the single-process oracle (prefill {secs_[0]:.3f} s, decode "
        f"{secs_[1]:.3f} s, {n / secs_[1]:.2f} tokens/s)"
        for name, (_, _, _, secs_) in zip(
            (f"granite-3-8b {MESH_LAYERS} layers",
             f"deepseek-moe-16b {MOE_LAYERS} layers expert-parallel"),
            wants.values()))
    print(f"mesh phase: {MESH_RANKS} gloo ranks on one GPU, "
          f"{secs:.1f} s from spawn to exit (each rank: start, weights, "
          f"checks); {oracle}; card {card_line()}")
    return scans, {name: run for name, run in out[0]["serve"].items()
                   if runs[name][3] == "tokens"}


def split_bytes(torch, cfg, shape) -> tuple[int, int]:
    """Bytes of ``cfg``'s f32 leaves that ``param_specs`` splits over a
    dim of the (data, model) mesh ``shape`` with more than one member,
    and of the leaves it keeps whole there (counted on the meta
    device)."""
    from types import SimpleNamespace
    from repro_torch.bridge import map_leaves
    from repro_torch.distributed.sharding import param_specs, spec_axes
    from repro_torch.models import transformer as tfm
    params = tfm.init_params(cfg, generator=None, device="meta",
                             dtype=torch.float32)
    sizes = dict(zip(("data", "model"), shape))
    mesh = SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(shape))
    out = [0, 0]

    def add(key, block, t, spec):
        split = any(sizes[a] > 1 for e in spec for a in spec_axes(e))
        out[0 if split else 1] += t.numel() * 4
    map_leaves(add, params, param_specs(params, mesh))
    return out[0], out[1]


def param_bytes(torch, cfg) -> int:
    """Bytes of ``cfg``'s f32 params, counted on the meta device."""
    from repro_torch.models import transformer as tfm
    params = tfm.init_params(cfg, generator=None, device="meta",
                             dtype=torch.float32)
    return tfm.param_count(params) * 4


def run_ranks(flag: str, directory, timeout: float, what: str,
              ranks: int = MESH_RANKS) -> None:
    """Start ``ranks`` processes of this script with ``flag RANK``, logs
    in ``directory``; fail unless all exit 0 within ``timeout``."""
    logs = [open(directory / f"rank_{r}.log", "w") for r in range(ranks)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r)],
        stdout=log, stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        # a rank that fails leaves the other waiting in a collective: stop
        # at the first non-zero exit, or at the deadline
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    if codes != [0] * ranks:
        for r in range(ranks):
            tail = (directory / f"rank_{r}.log").read_text()[-3000:]
            print(f"{what} rank {r} log (end):\n{tail}", file=sys.stderr)
        fail(f"{what}: ranks exited {codes} (None: still running, stopped)")


def mesh_kernel_checks(torch, mesh, seq_axes, depth: int, seed: int) -> list:
    """(a): the SP decode and the SP MLA context on this rank's shards
    against the single-device kernels (rows 3 and 6) and their plain
    versions; returns printable lines with this rank's ms per call."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels.mla_attention import mla_attention as mk
    from repro_torch.kernels.mla_attention import ref as mref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.transformer import sp_identity_tables
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 17)
    sa, lines = tuple(seq_axes), []
    n = coll.axis_size(mesh, sa)

    def shard(x):                            # this rank's pool rows
        return coll.local_shard(x, (sa,), mesh)

    def cols(tables, opt):                   # "sp_opt": its table columns
        return coll.local_shard(tables, (None, sa if opt else None), mesh)

    def check(what, got, kernel, plain, sp_ms, k_ms):
        e_k = (got - kernel).abs().max().item()
        e_p = (got - plain).abs().max().item()
        if not (e_k <= TOL and e_p <= TOL):
            fail(f"mesh {what}: max abs err {e_k} vs the kernel, {e_p} vs "
                 f"plain (> {TOL})")
        # the transport alone: one SUM of the accumulator's shape over the
        # ranks (the combine is one MAX of m and two SUMs, of l and acc)
        acc = torch.zeros_like(got)
        ar_ms = time_ms(torch, lambda: dist.all_reduce(acc), reps=10)
        lines.append(f"{what}: {sp_ms:.4f} ms per call on this rank "
                     f"(partials, all_reduce MAX + 2 SUM over {n} ranks; "
                     f"one gloo all_reduce of the {tuple(got.shape)} f32 "
                     f"accumulator {ar_ms:.4f} ms), single-device kernel "
                     f"{k_ms:.4f} ms; max abs err {e_k:.3g} vs the kernel, "
                     f"{e_p:.3g} vs plain")

    # GQA at granite-3-8b's attention widths, the engine's 8 sequences
    Mg = 2560 // BS
    N = len(PROMPT_LENS) * Mg
    q = torch.randn(len(PROMPT_LENS), KV * G, HD, generator=gen,
                    device=DEVICE)
    kv = torch.randn(N, BS, 2 * KV, HD, generator=gen, device=DEVICE)
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device=DEVICE)
    k_l, v_l = attn_mod.split_fused_kv(shard(kv))
    k, v = attn_mod.split_fused_kv(kv)
    for impl, tables in (
            ("sp", torch.randperm(N, generator=gen, device=DEVICE).reshape(
                -1, Mg).to(torch.int32)),
            ("sp_opt", sp_identity_tables(len(PROMPT_LENS), Mg, N, 1, n,
                                          device=DEVICE))):
        opt = impl == "sp_opt"

        def sp():
            return coll.paged_decode_attention_sp(
                q, k_l, v_l, cols(tables, opt), lengths, mesh=mesh,
                batch_axes=(), seq_axes=sa, table_cols_sharded=opt)

        def kernel():
            return pa_ops.paged_attention(q, kv, tables, lengths,
                                          buffer_depth=depth)
        check(f"paged decode {impl} (B {len(PROMPT_LENS)}, KV {KV}, G {G}, "
              f"hd {HD}, 300-2500 tokens)", sp(), kernel(),
              attn_mod.paged_decode_attention_ref(q, k, v, tables, lengths),
              time_ms(torch, sp, reps=10), time_ms(torch, kernel, reps=10))
    # the absorbed-MLA context at DeepSeek-V2's widths
    c = mla_case(torch, gen, W=1)
    c_l, kr_l = shard(c["c"]), shard(c["kr"])
    args = (c["q_lat"], c["q_rope"], c["c"], c["kr"], c["stack"],
            c["lengths"])
    for impl, tables in (
            ("sp", c["tables"]),
            ("sp_opt", sp_identity_tables(MLA_B, MLA_M, c["c"].shape[0], 1,
                                          n, device=DEVICE))):
        opt = impl == "sp_opt"
        if opt:                 # the identity layout: the same work
            args = args[:4] + (stack_tables(torch, tables, 1),
                               c["lengths"])

        def sp():
            return coll.mla_ctx_sp(
                c["q_lat"], c["q_rope"], c_l, kr_l, cols(tables, opt),
                c["lengths"], scale=MLA_SCALE, mesh=mesh, batch_axes=(),
                seq_axes=sa, table_cols_sharded=opt)

        def kernel():
            return mk.mla_paged_ctx_fwd(*args, scale=MLA_SCALE)
        check(f"MLA context {impl} (B {MLA_B}, H {MLA_H}, rank {RANK}, "
              f"rope {ROPE}, {MLA_M} blocks)", sp(), kernel(),
              mref.mla_paged_ctx_ref(*args, scale=MLA_SCALE),
              time_ms(torch, sp, reps=10), time_ms(torch, kernel, reps=10))
    return lines


def moe_mesh_run(torch, mesh, ba, sa, seed: int):
    """(c): DeepSeek-MoE cut to MOE_LAYERS served over the mesh with its
    MoE layers expert-parallel: the rank keeps only its experts
    (``sharding.expert_shards``) and drops the whole stacks, then
    ``prefill(mesh=)`` and HYBRID_NEW greedy ``decode_step(page_impl=
    "sp")`` steps; returns a printable line and the tokens by row."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import expert_shards
    from repro_torch.models import transformer as tfm
    cfg = moe_mesh_config()
    whole = moe_mesh_params(torch, cfg, seed + 23)
    whole_bytes = tfm.param_count(whole) * 4
    whole_experts = expert_bytes(cfg, whole)
    params = expert_shards(whole, cfg, mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    n = coll.axis_size(mesh, ("model",))
    held = expert_bytes(cfg, params)
    if held * n != whole_experts:
        fail(f"expert-parallel rank holds {held} B of experts, expected "
             f"{whole_experts} / {n}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    prompts = mesh_prompts(torch, cfg, seed)
    B, S = MESH_PROMPT
    st = tfm.init_decode_state(
        cfg, B, S + HYBRID_NEW + 1, dtype=torch.float32,
        batch_shards=coll.axis_size(mesh, ba),
        seq_shards=coll.axis_size(mesh, sa), device=DEVICE)
    st = coll.local_state(st, cfg, mesh, batch_axes=ba, seq_axes=sa)
    kw = dict(mesh=mesh, batch_axes=ba, seq_axes=sa)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, st = tfm.prefill(params, cfg, prompts, st, **kw)
    toks = [lg.argmax(-1)]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_ms = []
    for _ in range(HYBRID_NEW):
        t0 = time.perf_counter()
        lg, st = tfm.decode_step(params, cfg, st, toks[-1].to(torch.int32),
                                 page_impl="sp", **kw)
        toks.append(lg.argmax(-1))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    expect_launches(launch_counts(), {}, "the expert-parallel mesh run")
    peak = torch.cuda.max_memory_allocated()
    mo = cfg.moe
    line = (f"{cfg.name} {MOE_LAYERS} layers expert-parallel on mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: this rank holds "
            f"{mo.num_experts // n} of {mo.num_experts} experts a MoE layer, "
            f"{held / 1e9:.3f} GB of experts of the whole model's "
            f"{whole_experts / 1e9:.3f} GB (params "
            f"{tfm.param_count(params) * 4 / 1e9:.3f} of "
            f"{whole_bytes / 1e9:.3f} GB); resident {resident / 1e9:.3f} GB"
            f", peak {peak / 1e9:.3f} GB; prefill {B}x{S} {prefill_s:.3f} s,"
            f" decode {statistics.median(step_ms):.2f} ms a step (median of "
            f"{HYBRID_NEW}; {B * HYBRID_NEW / sum(step_ms) * 1e3:.2f} "
            f"tokens/s), no kernel launched; card {card_line()}")
    return line, torch.stack(toks, 1).tolist()


def serve_blocks(torch, mesh, cfg, make, prompts, *, impl: str,
                 extras=None) -> dict:
    """(d): ``cfg`` served from this rank's ``param_specs`` blocks
    (``sharding.shard_params``, the whole params dropped first) through a
    ``Layout``: ``prefill(impl=..., **extras)`` of the rank's rows of
    ``prompts`` (and of ``extras``: whisper's ``enc_frames``), then
    HYBRID_NEW greedy ``decode_step(page_impl="sp")`` steps.  The
    tokens of the whole batch by row, the resident memory before prefill
    and the peak, the kernels launched in prefill and in decode, the
    collectives' calls and bytes of the prefill and of each decode step,
    and seconds."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import parallel, sharding
    from repro_torch.models import transformer as tfm
    sharded = sharding.shard_params(make(cfg), mesh)
    gc.collect()
    torch.cuda.empty_cache()
    lay = parallel.Layout(cfg, mesh, sharding.param_specs(sharded, mesh),
                          parallel.shapes_of(sharded))
    params = sharding.local_blocks(sharded)
    B, S = prompts.shape
    ba, sa = sharding.decode_axes(mesh, batch=B)
    st = tfm.init_decode_state(
        cfg, B, S + HYBRID_NEW + 1, dtype=torch.float32,
        batch_shards=coll.axis_size(mesh, ba),
        seq_shards=coll.axis_size(mesh, sa), device=DEVICE)
    st = coll.local_state(st, cfg, mesh, batch_axes=ba, seq_axes=sa,
                          layout=lay)
    rows = coll.local_shard(prompts, (ba,), mesh).clone()
    extras = {k: coll.local_shard(v, (ba,), mesh).clone()
              for k, v in (extras or {}).items()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    kw = dict(batch_axes=ba, seq_axes=sa, layout=lay)
    reset_launches()
    coll.TRAFFIC.reset()
    t0 = time.perf_counter()
    lg, st = tfm.prefill(params, cfg, rows, st, impl=impl, **extras, **kw)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = [launch_counts()]
    traffic = {"prefill": [coll.TRAFFIC.calls, coll.TRAFFIC.bytes],
               "decode": []}
    toks = [lg.argmax(-1)]
    reset_launches()
    step_s = []
    for _ in range(HYBRID_NEW):
        coll.TRAFFIC.reset()
        t0 = time.perf_counter()
        lg, st = tfm.decode_step(params, cfg, st, toks[-1].to(torch.int32),
                                 page_impl="sp", **kw)
        toks.append(lg.argmax(-1))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        traffic["decode"].append([coll.TRAFFIC.calls, coll.TRAFFIC.bytes])
    launches.append(launch_counts())
    peak = torch.cuda.max_memory_allocated()
    whole = coll.gather_batch(torch.stack(toks, 1), mesh, ba, B)
    held = tfm.param_count(params) * 4
    del params, sharded, st, extras
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens": dict(enumerate(whole.tolist())), "resident": resident,
            "peak": peak, "held": held, "launches": launches,
            "traffic": traffic, "prefill_s": prefill_s,
            "decode_s": sum(step_s), "batch_axes": list(ba)}


def serve_line(name: str, run: dict, whole: int, B: int) -> str:
    """A printable line of a :func:`serve_blocks` run."""
    calls, nbytes = run["traffic"]["decode"][0]
    pcalls, pbytes = run["traffic"]["prefill"]
    return (f"{name} served from its param_specs blocks (batch axes "
            f"{run['batch_axes']}): holds {run['held'] / 1e9:.3f} GB of "
            f"params, resident {run['resident'] / 1e9:.3f} GB before prefill "
            f"({run['resident'] / whole:.4f} of one process's "
            f"{whole / 1e9:.3f} GB of weights), peak {run['peak'] / 1e9:.3f}"
            f" GB; prefill {run['prefill_s']:.3f} s ({pcalls} collectives, "
            f"{pbytes / 1e9:.4f} GB), {HYBRID_NEW} decode steps "
            f"{run['decode_s']:.3f} s ({B * HYBRID_NEW / run['decode_s']:.2f}"
            f" tokens/s; a step {calls} collectives, {nbytes / 1e9:.4f} GB); "
            f"launches {run['launches']}; card {card_line()}")


def mesh_rank(rank: int) -> int:
    """One rank of phase 10 (``--mesh-rank``): (a) the kernel checks, (b)
    granite-3-8b cut to MESH_LAYERS over the mesh, then (c) DeepSeek-MoE
    cut to MOE_LAYERS expert-parallel; writes its lines and tokens to
    ``MESH_DIR/rank_<rank>.json``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import decode_axes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    args = json.loads((MESH_DIR / "args.json").read_text())
    seed = args["seed"]
    dist.init_process_group(
        "gloo", init_method=f"file://{MESH_DIR / 'store'}", rank=rank,
        world_size=MESH_RANKS, timeout=timedelta(seconds=180))
    try:
        mesh = make_host_mesh(1, MESH_RANKS)
        cfg = mesh_config()
        ba, sa = decode_axes(mesh, batch=MESH_PROMPT[0])
        with torch.no_grad():
            lines = mesh_kernel_checks(torch, mesh, sa, args["depth"], seed)
            params = mesh_params(torch, cfg, seed)
            prompts = mesh_prompts(torch, cfg, seed)
            B, S = MESH_PROMPT
            st = tfm.init_decode_state(
                cfg, B, S + HYBRID_NEW + 1, dtype=torch.float32,
                batch_shards=coll.axis_size(mesh, ba),
                seq_shards=coll.axis_size(mesh, sa), device=DEVICE)
            st = coll.local_state(st, cfg, mesh, batch_axes=ba, seq_axes=sa)
            kw = dict(mesh=mesh, batch_axes=ba, seq_axes=sa)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, st = tfm.prefill(params, cfg, prompts, st, **kw)
            toks = [lg.argmax(-1)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(HYBRID_NEW):
                lg, st = tfm.decode_step(params, cfg, st, toks[-1].to(
                    torch.int32), page_impl="sp", **kw)
                toks.append(lg.argmax(-1))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            expect_launches(launch_counts(), {}, "the mesh model run")
        rows = torch.stack(toks, 1).tolist()
        lines.append(
            f"{cfg.name} {MESH_LAYERS} layers on mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
            f" (batch axes {ba}, seq axes {sa}): prefill {B}x{S} "
            f"{t1 - t0:.3f} s, {HYBRID_NEW} decode steps {t2 - t1:.3f} s "
            f"({B * HYBRID_NEW / (t2 - t1):.2f} tokens/s), no kernel "
            f"launched; card {card_line()}")
        del params, st
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            line, moe_rows = moe_mesh_run(torch, mesh, ba, sa, seed)
        lines.append(line)
        gc.collect()
        torch.cuda.empty_cache()
        meshes = {(1, MESH_RANKS): mesh}
        serve = {}
        for name, (shape, cfg, make, key) in serve_runs(seed).items():
            if shape not in meshes:          # every rank makes each once
                meshes[shape] = make_host_mesh(*shape)
            run = serve_blocks(
                torch, meshes[shape], cfg, functools.partial(make, torch),
                mesh_prompts(torch, cfg, seed),
                impl="chunked" if key == "tokens" else "kernel")
            serve[name] = run
            lines.append(serve_line(name, run, param_bytes(torch, cfg),
                                    MESH_PROMPT[0]))
        (MESH_DIR / f"rank_{rank}.json").write_text(json.dumps(
            {"lines": lines, "tokens": dict(enumerate(rows)),
             "moe_tokens": dict(enumerate(moe_rows)), "serve": serve}))
    finally:
        dist.destroy_process_group()
    return 0


# phase 11: training on a mesh, two ranks on the one GPU over gloo
TRAIN_MESH_STEPS = 2
#: (data, model): FSDP, then tensor parallel with the vocab-parallel loss
TRAIN_MESHES = ((2, 1), (1, 2))
TRAIN_MESH_RTOL = 1e-5
#: the FSDP mesh's resident state per rank, at most this share of phase
#: 9's before its first step
TRAIN_MESH_RESIDENT = 0.55
#: pipeline_apply: microbatches of (1, 1024, d_model), one layer a stage
PIPE_MICRO = (4, 1, 1024)
PIPE_TOL = 1e-5
TRAIN_MESH_TIMEOUT = 900    # seconds for both ranks, the probe included
#: the runs of phase 9's model, held against phase 9 (a)
TRAIN_MESH_NAMES = tuple(f"{d}x{m}" for d, m in TRAIN_MESHES)
TRAIN_MESH_DIR = ROOT / "build" / "train_mesh_phase"


def train_config_of():
    """Phase 9's model: granite-3-8b cut to TRAIN_LAYERS."""
    return cut_config("granite-3-8b", TRAIN_LAYERS)


def pipe_case(torch, seed: int):
    """granite-3-8b's first two layers (one a stage) and PIPE_MICRO
    microbatches, the same in every process; the stage function."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import attn_layer
    from repro_torch.models.layers import dense_ffn
    cfg = cut_config("granite-3-8b", 2)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 19)
    params = tfm.init_params(cfg, generator=gen, device=DEVICE,
                             dtype=torch.float32)
    layers = [tfm.layer_params(params, cfg, i) for i in range(2)]
    x = torch.randn(PIPE_MICRO + (cfg.d_model,), generator=gen,
                    device=DEVICE)

    def stage(p, a):
        pos = torch.arange(a.shape[1], device=a.device)[None].expand(
            a.shape[0], -1)
        h = attn_layer(p["mix"], a, pos, cfg, impl="chunked")
        return dense_ffn(p["ffn"], h, cfg.norm_eps)
    return layers, x, stage


#: (c): the expert-parallel step's mesh, trained from its own oracle
MOE_TRAIN_MESH = (1, 2)
#: (d): the tensor-parallel mixers' mesh, and each model's layers (its
#: published widths; RWKV-6-7B's first 2, DeepSeek-V2's and Jamba's layer
#: 0: MLA and Mamba, each with a dense FFN) and params seed offset
MIXER_TRAIN_MESH = (1, 2)
MIXER_TRAIN = {"rwkv6-7b": (2, 31), "deepseek-v2-236b": (1, 37),
               "jamba-v0.1-52b": (1, 41)}


def train_runs(seed: int) -> dict:
    """Phase 11's runs on a mesh besides phase 9's model: name → (mesh,
    config, params seed)."""
    runs = {"moe-{}x{}".format(*MOE_TRAIN_MESH): (
        MOE_TRAIN_MESH, moe_mesh_config(), seed + 29)}
    for arch, (layers, off) in MIXER_TRAIN.items():
        runs["{}-{}x{}".format(arch, *MIXER_TRAIN_MESH)] = (
            MIXER_TRAIN_MESH, cut_config(arch, layers), seed + off)
    return runs


def train_oracle(torch, cfg, seed: int, what: str) -> dict:
    """A mesh run's single-process oracle: ``cfg`` trained
    TRAIN_MESH_STEPS steps of TRAIN_BATCH ``SyntheticLM`` batches from
    seeded f32 params (``make_train_step(cfg, TrainConfig())``), run and
    freed before the ranks start (the MoE model's params, gradients and
    AdamW moments are about 36 GB); the record :func:`train_on_mesh`
    gives, and the peak."""
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_loop as ttl
    t0 = time.perf_counter()
    params = moe_mesh_params(torch, cfg, seed)
    made_line(torch, cfg, params, t0, f"{cfg.n_layers} layers ({what})")
    step = ttl.make_train_step(cfg, ttl.TrainConfig())
    opt = topt.init_opt_state(params)
    err = torch.zeros((), device=DEVICE)
    zero = [k for k, v in leaf_sumsq(torch, params).items() if v == 0.0]
    batches = train_batches(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    steps = []
    for b in batches:
        t1 = time.perf_counter()
        params, opt, err, m = step(params, opt, err, b)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        steps.append({"loss": loss, "grad_norm": gnorm,
                      "secs": time.perf_counter() - t1})
    peak = torch.cuda.max_memory_allocated()
    expect_launches(launch_counts(), {}, f"the {what} step")
    out = {"loss": [h["loss"] for h in steps],
           "grad_norm": [h["grad_norm"] for h in steps],
           "sumsq": leaf_sumsq(torch, params), "zero": zero,
           "resident": resident, "peak": peak}
    B, S = TRAIN_BATCH
    print(f"{cfg.name} {what} ({cfg.n_layers} layers, one process): "
          f"losses {out['loss']}, grad norms {out['grad_norm']}; seconds "
          f"per step {[round(h['secs'], 4) for h in steps]} "
          f"({B * S / steps[-1]['secs']:.1f} tokens/s at the last); "
          f"resident {resident / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB")
    del params, opt, err, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_batches(torch, cfg) -> list:
    """TRAIN_MESH_STEPS ``SyntheticLM`` batches of TRAIN_BATCH on the
    card, the same in every process; an encoder-decoder model's with
    seeded random frames."""
    from repro_torch.training.data import DataConfig, SyntheticLM
    B, S = TRAIN_BATCH
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B))
    out = [{k: torch.as_tensor(v, device=DEVICE)
            for k, v in data.batch(s).items()}
           for s in range(TRAIN_MESH_STEPS)]
    if cfg.enc_dec:
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        for b in out:
            b["frames"] = torch.randn(B, cfg.enc_len, cfg.d_model,
                                      generator=gen, device=DEVICE)
    return out


def train_mesh_phase(torch, seed: int, oracle: dict) -> dict:
    """The single-process steps of (c) and (d) and the sequential
    pipeline oracle, then MESH_RANKS processes of
    :func:`train_mesh_rank`; fails unless both exit 0 and their numbers
    hold against phase 9 (a)'s (``oracle``), each run's oracle and the
    pipeline's.  Returns rank 0's runs (for phase 12)."""
    import shutil
    oracles = {f"{d}x{m}": oracle for d, m in TRAIN_MESHES}
    for name, (shape, cfg, cfg_seed) in train_runs(seed).items():
        what = ("the expert-parallel training oracle"
                if name.startswith("moe") else
                "the tensor-parallel mixer's training oracle")
        oracles[name] = train_oracle(torch, cfg, cfg_seed, what)
    layers, x, stage = pipe_case(torch, seed)
    with torch.no_grad():
        want = x
        for lp in layers:
            want = torch.stack([stage(lp, m) for m in want])
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    TRAIN_MESH_DIR.mkdir(parents=True)
    torch.save(want.cpu(), TRAIN_MESH_DIR / "pipe_want.pt")
    del layers, x, want
    gc.collect()
    torch.cuda.empty_cache()
    (TRAIN_MESH_DIR / "args.json").write_text(json.dumps({"seed": seed}))
    t0 = time.perf_counter()
    run_ranks("--train-rank", TRAIN_MESH_DIR, TRAIN_MESH_TIMEOUT,
              "training mesh phase")
    secs = time.perf_counter() - t0
    out = [json.loads((TRAIN_MESH_DIR / f"rank_{r}.json").read_text())
           for r in range(MESH_RANKS)]
    for line in out[0]["probe"]:
        print(f"training mesh probe (rank 0): {line}")

    for name in out[0]["runs"]:
        oracle = oracles[name]
        what = "phase 9 (a)" if name in TRAIN_MESH_NAMES else "its oracle"
        for r, res in enumerate(out):
            run = res["runs"][name]
            if name == "2x1" and run["resident"] > (
                    TRAIN_MESH_RESIDENT * oracle["resident"]):
                fail(f"training mesh {name} rank {r}: {run['resident']} B "
                     f"resident > {TRAIN_MESH_RESIDENT} x phase 9's "
                     f"{oracle['resident']}")
            check_train_run(f"training mesh {name}", r, run, oracle, what)
    for r, res in enumerate(out):
        p = res["pipeline"]
        if not p["err"] <= PIPE_TOL * max(1.0, p["scale"]):
            fail(f"pipeline_apply rank {r}: max abs err {p['err']} vs the "
                 f"sequential layers (max |want| {p['scale']})")
        print(f"pipeline_apply rank {r}: 2 stages of one granite-3-8b layer,"
              f" {PIPE_MICRO[0]} microbatches of {PIPE_MICRO[1:]} x 4096: "
              f"{p['secs']:.3f} s, max abs err {p['err']:.3g} vs the "
              f"sequential layers (max |want| {p['scale']:.3g})")
    print(f"training mesh phase: {MESH_RANKS} gloo ranks on one GPU, "
          f"{secs:.1f} s from spawn to exit; no kernel launched; card "
          f"{card_line()}")
    return out[0]["runs"]


def check_train_run(name: str, r: int, run: dict, oracle: dict,
                    what: str, zero_rtol: float | None = None) -> None:
    """Rank ``r``'s :func:`train_on_mesh` record against its one-process
    ``oracle``: loss and grad norm at every step and each leaf's sum of
    squares within TRAIN_MESH_RTOL relative (with ``zero_rtol``, a leaf
    that starts at zero within that: the oracle's ``zero``); prints its
    line."""
    def rel(x, y):
        return abs(x - y) / abs(y)
    B, S = TRAIN_BATCH
    for s, h in enumerate(run["steps"]):
        for k in ("loss", "grad_norm"):
            if not rel(h[k], oracle[k][s]) <= TRAIN_MESH_RTOL:
                fail(f"{name} rank {r} step {s} {k} {h[k]} vs {what} "
                     f"{oracle[k][s]}")
    if set(run["sumsq"]) != set(oracle["sumsq"]):
        fail(f"{name} rank {r}: leaves {sorted(run['sumsq'])} vs {what}'s "
             f"{sorted(oracle['sumsq'])}")
    zero = set(oracle["zero"]) if zero_rtol is not None else set()
    off = {k: rel(v, oracle["sumsq"][k]) for k, v in run["sumsq"].items()}
    for k, e in off.items():
        if not e <= (zero_rtol if k in zero else TRAIN_MESH_RTOL):
            fail(f"{name} rank {r}: leaf {k}'s sum of squares off {what}'s "
                 f"by {e:.3g} relative")
    worst = max(off, key=off.get)
    zero_line = "".join(
        f", {k} {off[k]:.3g}" for k in sorted(zero) if k != worst)
    if zero:
        zero_line = (f"; the leaves that start at zero: {zero_line[2:]}"
                     if zero_line else "")
    steps = run["steps"]
    off_step = {k: max(rel(h[k], oracle[k][s]) for s, h in enumerate(steps))
                for k in ("loss", "grad_norm")}
    print(
        f"{name} (data, model) rank {r}: losses "
        f"{[h['loss'] for h in steps]}, grad norms "
        f"{[h['grad_norm'] for h in steps]} (worst relative to "
        f"{what}: loss {off_step['loss']:.3g}, grad norm "
        f"{off_step['grad_norm']:.3g}, leaf sums of squares {off[worst]:.3g}"
        f" ({worst}){zero_line}); seconds per step "
        f"{[round(h['secs'], 4) for h in steps]} ("
        f"{B * S / steps[-1]['secs']:.1f} tokens/s at the last); "
        f"collectives per step {[h['calls'] for h in steps]} calls, "
        f"{[round(h['bytes'] / 1e9, 3) for h in steps]} GB, "
        f"{[round(h['coll_secs'], 3) for h in steps]} s; resident "
        f"before the first step {run['resident'] / 1e9:.2f} GB "
        f"({run['resident'] / oracle['resident']:.3f} of {what}'s "
        f"{oracle['resident'] / 1e9:.2f} GB), peak "
        f"{run['peak'] / 1e9:.2f} GB" + (
            f" ({what}'s {oracle['peak'] / 1e9:.2f} GB)"
            if "peak" in oracle else "") + f"; card {card_line()}")


def train_on_mesh(torch, shape, cfg, seed: int) -> dict:
    """``cfg`` (seeded f32 params from ``seed``) trained TRAIN_MESH_STEPS
    steps of :func:`train_batches` on a (data, model) mesh of ``shape``:
    per step loss, grad norm, seconds and collectives; the memory
    resident before the first step and the peak; each leaf's sum of
    squares after the last step (its blocks' summed over the ranks, each
    block counted once)."""
    import torch.distributed as dist
    from repro_torch.bridge import map_leaves
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training import train_loop as ttl
    mesh = make_host_mesh(*shape, device_type=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    whole = tfm.init_params(cfg, generator=gen, device=DEVICE,
                            dtype=torch.float32)
    tc = ttl.TrainConfig()
    params, opt, err = ttl.shard_state(whole, None, tc, mesh)
    del whole
    batches = train_batches(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    step = ttl.make_train_step(cfg, tc, mesh)
    coll.TRAFFIC.timed = True
    reset_launches()
    steps = []
    for b in batches:
        coll.TRAFFIC.reset()
        t0 = time.perf_counter()
        params, opt, err, m = step(params, opt, err, b)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        steps.append({"loss": loss, "grad_norm": gnorm,
                      "secs": time.perf_counter() - t0,
                      "calls": coll.TRAFFIC.calls,
                      "bytes": coll.TRAFFIC.bytes,
                      "coll_secs": coll.TRAFFIC.seconds})
    coll.TRAFFIC.timed = False
    peak = torch.cuda.max_memory_allocated()
    expect_launches(launch_counts(), {}, f"the training mesh {shape}")
    world = coll.axis_size(mesh, tuple(mesh.mesh_dim_names))
    sums: dict = {}

    def add(key, _b, t, spec):
        share = coll.axis_size(mesh, coll.split_axes(spec)) / world
        sums[key] = sums.get(key, 0.0) + share * t.double().square().sum(
        ).item()
    map_leaves(add, sharding.local_blocks(params),
               sharding.param_specs(params, mesh))
    vec = torch.tensor(list(sums.values()), dtype=torch.float64)
    dist.all_reduce(vec)
    del params, opt, err, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": steps, "resident": resident, "peak": peak,
            "sumsq": dict(zip(sums, vec.tolist()))}


def pipeline_on_ranks(torch, seed: int) -> dict:
    """``pipeline_apply`` over a ("pipe",) mesh of the ranks, one granite
    layer a stage, against the parent's sequential application."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.bridge import tree_map
    from repro_torch.distributed.pipeline import pipeline_apply
    mesh = DeviceMesh(DEVICE, torch.arange(MESH_RANKS),
                      mesh_dim_names=("pipe",))
    layers, x, stage = pipe_case(torch, seed)
    mine = tree_map(lambda t: t[None], layers[mesh.get_local_rank("pipe")])
    del layers
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipeline_apply(stage, mine, x, mesh=mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    expect_launches(launch_counts(), {}, "pipeline_apply")
    want = torch.load(TRAIN_MESH_DIR / "pipe_want.pt").to(DEVICE)
    return {"err": (got - want).abs().max().item(),
            "scale": want.abs().max().item(), "secs": secs}


def train_mesh_rank(rank: int) -> int:
    """One rank of phase 11 (``--train-rank``): the collective probe,
    training phase 9's model on each of TRAIN_MESHES and :func:`train_runs`'
    models on theirs, then ``pipeline_apply``; writes
    its results to ``TRAIN_MESH_DIR/rank_<rank>.json``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import probe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    seed = json.loads((TRAIN_MESH_DIR / "args.json").read_text())["seed"]
    dist.init_process_group(
        "gloo", init_method=f"file://{TRAIN_MESH_DIR / 'store'}", rank=rank,
        world_size=MESH_RANKS, timeout=timedelta(seconds=300))
    try:
        lines = probe.describe(probe.probe())
        runs = {f"{d}x{m}": train_on_mesh(torch, (d, m), train_config_of(),
                                          seed + 11)
                for d, m in TRAIN_MESHES}
        for name, (shape, cfg, cfg_seed) in train_runs(seed).items():
            runs[name] = train_on_mesh(torch, shape, cfg, cfg_seed)
        pipe = pipeline_on_ranks(torch, seed)
        (TRAIN_MESH_DIR / f"rank_{rank}.json").write_text(json.dumps(
            {"probe": lines, "runs": runs, "pipeline": pipe}))
    finally:
        dist.destroy_process_group()
    return 0


# phase 10 (e) / 11 (e): attention whose query heads do not split evenly
# over ``model``, served and trained by three gloo ranks on the one GPU on
# a (data 1, model 3) mesh: (e1) qwen2.5-14b at its published widths cut
# to 2 of 48 layers (2.1 B params, 8.4 GB f32; 40 heads in blocks of 14,
# 14 and 12 reading KV heads 0-2, 2-5 and 5-7: neither 40 nor 8 divides
# 3), (e2) whisper-small whole (12 heads, 4 a rank, in the encoder, the
# decoder and the cross attention)
HEADS_RANKS = 3
HEADS_MESH = (1, HEADS_RANKS)
HEADS_TIMEOUT = 600         # seconds for the three ranks, weights and checks
HEADS_DIR = ROOT / "build" / "heads_phase"
#: (e1)'s name in phase 12 (a)'s replay
HEADS_NAME = "qwen2.5-14b-1x3"
#: the leaf sums of squares of (e)'s leaves that start at zero (qwen2.5's
#: QKV biases), against the oracle's: after TRAIN_MESH_STEPS steps such a
#: leaf is Adam's first updates lr·m/(√v + eps) alone, on gradients the
#: clip scales down to near eps, so f32 summation order shows: the
#: reference's and the port's one-process steps differ by 3.9e-5 on
#: ``bk``'s (qwen2.5 smoke config, 2 steps of TrainConfig(), CPU); every
#: other leaf is held to TRAIN_MESH_RTOL
HEADS_ZERO_RTOL = 1e-4


def heads_runs(seed: int) -> dict:
    """(e)'s runs: name → (config, params and inputs seed, prompt
    shape)."""
    from repro_torch.configs import get_config
    return {"qwen2.5-14b": (cut_config("qwen2.5-14b", 2), seed + 43,
                            MESH_PROMPT),
            "whisper-small": (get_config("whisper-small"), seed + 47,
                              ENCDEC_PROMPT)}


def heads_inputs(torch, cfg, seed: int, shape) -> tuple:
    """A run's prompts and ``prefill`` inputs (whisper's frames), the
    same in every process."""
    import numpy as np
    rng = np.random.RandomState(seed)
    prompts = torch.as_tensor(rng.randint(1, cfg.vocab, shape),
                              dtype=torch.int32, device=DEVICE)
    extras = {}
    if cfg.enc_dec:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        extras["enc_frames"] = torch.randn(shape[0], cfg.enc_len,
                                           cfg.d_model, generator=gen,
                                           device=DEVICE)
    return prompts, extras


def heads_phase(torch, seed: int) -> dict:
    """(e): each run's one-process oracles (``prefill`` + HYBRID_NEW
    greedy ``decode_step(page_impl="ref")``, and TRAIN_MESH_STEPS steps
    of ``make_train_step``), run and freed first; then HEADS_RANKS
    processes of :func:`heads_rank`.  Fails unless all exit 0, their
    tokens equal the oracle's on every rank (but at near-ties) and their
    training comes within TRAIN_MESH_RTOL of the oracle's.  Returns rank
    0's (e1) serving and training records (for phase 12)."""
    import shutil
    runs = heads_runs(seed)
    served, trained = {}, {}
    for name, (cfg, cfg_seed, shape) in runs.items():
        t0 = time.perf_counter()
        params = moe_mesh_params(torch, cfg, cfg_seed)
        made_line(torch, cfg, params, t0, f"{cfg.n_layers} layers (the "
                  f"uneven heads' serving oracle)")
        prompts, extras = heads_inputs(torch, cfg, cfg_seed, shape)
        with torch.no_grad():
            served[name] = greedy(torch, cfg, params, prompts,
                                  impl="chunked", page_impl="ref", **extras)
        del params, prompts, extras
        gc.collect()
        torch.cuda.empty_cache()
        trained[name] = train_oracle(torch, cfg, cfg_seed,
                                     "the uneven heads' training oracle")
    shutil.rmtree(HEADS_DIR, ignore_errors=True)
    HEADS_DIR.mkdir(parents=True)
    (HEADS_DIR / "args.json").write_text(json.dumps({"seed": seed}))
    t0 = time.perf_counter()
    run_ranks("--heads-rank", HEADS_DIR, HEADS_TIMEOUT, "uneven heads phase",
              ranks=HEADS_RANKS)
    secs = time.perf_counter() - t0
    out = [json.loads((HEADS_DIR / f"rank_{r}.json").read_text())
           for r in range(HEADS_RANKS)]
    for name, (cfg, _, (B, S)) in runs.items():
        want, margins, _, ref_secs = served[name]
        for r, res in enumerate(out):
            run = res["serve"][name]
            got = {int(b): v for b, v in run["tokens"].items()}
            if got != {int(b): v for b, v in
                       out[0]["serve"][name]["tokens"].items()}:
                fail(f"uneven heads rank {r}'s {name} tokens differ from "
                     f"rank 0's")
            check_tokens(got, want, margins, f"uneven heads rank {r} {name}")
            expect_launches(run["launches"][0], {}, f"uneven heads rank {r} "
                            f"{name} prefill")
            expect_launches(run["launches"][1], {}, f"uneven heads rank {r} "
                            f"{name} decode")
            print(f"uneven heads rank {r}, {res['heads'][name]}: "
                  + serve_line(f"{name} ({cfg.n_layers} layers) on "
                               f"{HEADS_MESH}", run, param_bytes(torch, cfg),
                               B))
            check_train_run(f"uneven heads {name} on {HEADS_MESH}", r,
                            res["train"][name], trained[name],
                            "its oracle", HEADS_ZERO_RTOL)
        print(f"uneven heads {name} over the mesh: {B * (HYBRID_NEW + 1)} "
              f"tokens equal the single-process oracle (prefill "
              f"{ref_secs[0]:.3f} s, decode {ref_secs[1]:.3f} s, "
              f"{B * HYBRID_NEW / ref_secs[1]:.2f} tokens/s)")
    print(f"uneven heads phase: {HEADS_RANKS} gloo ranks on one GPU, "
          f"{secs:.1f} s from spawn to exit (each rank: start, weights, "
          f"serving and training); no kernel launched; card {card_line()}")
    return {"serve": out[0]["serve"]["qwen2.5-14b"],
            "train": out[0]["train"]["qwen2.5-14b"]}


def heads_rank(rank: int) -> int:
    """One rank of (e) (``--heads-rank``): each of :func:`heads_runs`'
    models served from this rank's ``param_specs`` blocks
    (:func:`serve_blocks`) and trained (:func:`train_on_mesh`) on
    HEADS_MESH; writes its results to ``HEADS_DIR/rank_<rank>.json``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed.parallel import TensorParallel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.attention import rank_heads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    seed = json.loads((HEADS_DIR / "args.json").read_text())["seed"]
    dist.init_process_group(
        "gloo", init_method=f"file://{HEADS_DIR / 'store'}", rank=rank,
        world_size=HEADS_RANKS, timeout=timedelta(seconds=300))
    try:
        mesh = make_host_mesh(*HEADS_MESH, device_type=DEVICE)
        tp = TensorParallel(mesh)
        heads, serve, train = {}, {}, {}
        for name, (cfg, cfg_seed, shape) in heads_runs(seed).items():
            q0, n, k0, k1, _ = rank_heads(cfg, tp)
            heads[name] = (f"query heads {q0}-{q0 + n - 1} ({n} of "
                           f"{cfg.n_heads}), KV heads {k0}-{k1 - 1} of "
                           f"{cfg.n_kv_heads}")
            prompts, extras = heads_inputs(torch, cfg, cfg_seed, shape)
            serve[name] = serve_blocks(
                torch, mesh, cfg,
                lambda c, s=cfg_seed: moe_mesh_params(torch, c, s),
                prompts, impl="chunked", extras=extras)
            del prompts, extras
            train[name] = train_on_mesh(torch, HEADS_MESH, cfg, cfg_seed)
        (HEADS_DIR / f"rank_{rank}.json").write_text(json.dumps(
            {"heads": heads, "serve": serve, "train": train}))
    finally:
        dist.destroy_process_group()
    return 0


# phase 12: the dry run (launch/dryrun.py) on fake tensors, in subprocesses
DRYRUN_DIR = ROOT / "build" / "dryrun_phase"
#: phase 11's step on its two meshes, predicted as rank 0 of 2 fake ranks
DRYRUN_RESIDENT_RTOL = 0.02     # resident state against memory_allocated
DRYRUN_PEAK_RTOL = 0.15         # MemTracker's peak against the allocator's
DRYRUN_FLOPS_RTOL = 1e-9        # FLOPs on both ranks against train_flops
DRYRUN_TIMEOUT = 600            # seconds for (a)'s nine runs
#: (b): one production cell on the 256-rank fake mesh, started beside (a)
#: once every timed phase has ended, its depth cut to DRYRUN_CELL_LAYERS
#: (every op of every microbatch runs on the host: all 40 layers took
#: 271-375 s, 10 layers 100-133 s, past (a)'s 58-74 s)
DRYRUN_CELL = ("granite-3-8b", "train_4k")
DRYRUN_CELL_LAYERS = 4
DRYRUN_CELL_TIMEOUT = 800       # seconds from the phase's start


def start_dryrun(what: str):
    """``--dryrun-phase what`` in a subprocess, its output in
    DRYRUN_DIR/<what>.log: it needs no card."""
    log = open(DRYRUN_DIR / f"{what}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dryrun-phase",
         what], stdout=log, stderr=subprocess.STDOUT)
    atexit.register(proc.kill)               # a failing phase stops it too
    return proc, log


def wait_dryrun(what: str, run, timeout: float) -> None:
    """Wait for a ``start_dryrun`` subprocess; fail if it failed."""
    proc, log = run
    try:
        code = proc.wait(timeout=max(1.0, timeout))
        why = f"exited {code}"
    except subprocess.TimeoutExpired:
        code, why = -1, f"not done after {timeout:.0f} s"
    finally:
        proc.kill()
        proc.wait()
        log.close()
    if code:
        print((DRYRUN_DIR / f"{what}.log").read_text()[-3000:],
              file=sys.stderr)
        fail(f"dry-run phase ({what}): {why}")


def dryrun_subprocess(what: str) -> int:
    """The body of ``--dryrun-phase``: ``predict`` dry-runs phase 11's
    step on both TRAIN_MESHES (2 fake ranks, fake CUDA tensors) and
    writes the records to DRYRUN_DIR/predict.json; ``production`` runs
    DRYRUN_CELL on the 256-rank fake mesh into DRYRUN_DIR, on meta
    tensors (two to three times faster than fake ones; (a) runs fake
    CUDA tensors, whose storages MemTracker rounds as the card's
    allocator does)."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.collectives import make_groups
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if what == "production":
        arch, shape = DRYRUN_CELL
        rec = dryrun.run_cell(arch, shape, out_dir=str(DRYRUN_DIR),
                              verbose=True, device="meta",
                              cfg=cut_config(arch, DRYRUN_CELL_LAYERS))
        rec["wall_s"] = time.perf_counter() - t0
        (DRYRUN_DIR / "production.json").write_text(json.dumps(rec))
        return 0
    dryrun.fake_world(MESH_RANKS)
    B, S = TRAIN_BATCH
    out = {}
    for name, arch, cfg, (d, m) in (
            [(f"{d}x{m}", "granite-3-8b", train_config_of(), (d, m))
             for d, m in TRAIN_MESHES]
            # a run's name as the cell's arch: the production cell's
            # choices keyed by arch (DeepSeek-V2's bf16 AdamW moments) are
            # not the step phase 11 runs (TrainConfig()'s f32 ones)
            + [(name, name, cfg, shape) for name, (shape, cfg, _)
               in train_runs(0).items()]):
        mesh = make_host_mesh(d, m, device_type=DEVICE)
        make_groups(mesh)
        out[name] = dryrun.run_cell(
            arch, "phase11", mesh=mesh, verbose=False, cfg=cfg,
            shape=ShapeSpec("phase11", S, B, "train"),
            param_dtype=torch.float32, microbatches=1, moe_groups=1)
    B, S = MESH_PROMPT                       # phase 10 (d)'s granite runs
    for d, m in SERVE_MESHES:
        mesh = make_host_mesh(d, m, device_type=DEVICE)
        make_groups(mesh)
        for kind in ("prefill", "decode"):
            out[f"granite-{d}x{m}-{kind}"] = dryrun.run_cell(
                "granite-3-8b", f"phase10_{kind}", mesh=mesh, verbose=False,
                cfg=mesh_config(), shape=ShapeSpec(f"phase10_{kind}", S, B,
                                                   kind),
                param_dtype=torch.float32, moe_groups=1)
    # (e1): qwen2.5-14b's training step, prefill and decode on 3 fake ranks
    dryrun.fake_world(HEADS_RANKS)
    mesh = make_host_mesh(*HEADS_MESH, device_type=DEVICE)
    make_groups(mesh)
    cfg, _, (B, S) = heads_runs(0)["qwen2.5-14b"]
    name = HEADS_NAME
    for kind, (b, s) in (("train", TRAIN_BATCH), ("prefill", (B, S)),
                         ("decode", (B, S))):
        out[f"{name}-{kind}"] = dryrun.run_cell(
            name, f"heads_{kind}", mesh=mesh, verbose=False, cfg=cfg,
            shape=ShapeSpec(f"heads_{kind}", s, b, kind),
            param_dtype=torch.float32, microbatches=1, moe_groups=1)
    out["wall_s"] = time.perf_counter() - t0
    (DRYRUN_DIR / "predict.json").write_text(json.dumps(out))
    return 0


def check_served(name: str, run: dict, pred: dict, ranks: int) -> None:
    """A served run's (:func:`serve_blocks`, rank 0) calls and bytes
    against the dry run's prefill and decode cells (``pred[name +
    "-prefill"]``, ``"-decode"``): equal for the prefill and every decode
    step, the resident state within DRYRUN_RESIDENT_RTOL; prints its
    line."""
    line = []
    for kind in ("prefill", "decode"):
        p = pred[f"{name}-{kind}"]
        want = (p["collectives"]["calls"], p["collectives"]["bytes"])
        for s, got in enumerate([run["traffic"]["prefill"]]
                                if kind == "prefill"
                                else run["traffic"]["decode"]):
            if tuple(got) != want:
                fail(f"dry run of {name} {kind}: step {s} made {got[0]} "
                     f"collectives of {got[1]} B, predicted {want[0]} of "
                     f"{want[1]} B")
        res = p["memory"]["argument_bytes"] / run["resident"] - 1
        if abs(res) > DRYRUN_RESIDENT_RTOL:
            fail(f"dry run of {name} {kind}: resident "
                 f"{p['memory']['argument_bytes']} B vs measured "
                 f"{run['resident']} ({res:+.3%})")
        line.append(f"{kind} {want[0]} collectives of {want[1] / 1e9:.4f} GB "
                    f"{p['collectives']['payload_by_kind']}, resident "
                    f"{p['memory']['argument_bytes'] / 1e9:.3f} GB "
                    f"({res:+.3%}), peak {p['memory']['peak_bytes'] / 1e9:.3f}"
                    f" GB")
    print(f"dry run of {name} serving, rank 0 of {ranks} fake ranks (calls "
          f"and bytes equal the measured prefill and every decode step; "
          f"resident vs measured {run['resident'] / 1e9:.3f} GB): "
          + "; ".join(line))


def dryrun_phase(measured: dict, served: dict, heads: dict) -> None:
    """Phase 12, after every timed phase: (a) phase 11's steps and (e1)'s
    (``heads["train"]``) predicted on fake tensors, held against their
    measurement in this run: collective calls and bytes equal at every
    step, the resident state within DRYRUN_RESIDENT_RTOL of
    ``memory_allocated``, MemTracker's peak within DRYRUN_PEAK_RTOL of
    ``max_memory_allocated``, granite's FLOPs on both ranks within
    DRYRUN_FLOPS_RTOL of ``train_flops``; and phase 10 (d)'s granite
    serving runs (``served``: rank 0's) and (e1)'s (``heads["serve"]``)
    replayed as a prefill and a decode cell: calls and bytes equal the
    prefill's and every decode step's, the resident state within
    DRYRUN_RESIDENT_RTOL.  (b) the production cell, run beside (a): its
    record line."""
    import shutil
    t0 = time.perf_counter()
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    runs = {what: start_dryrun(what) for what in ("predict", "production")}
    wait_dryrun("predict", runs["predict"], DRYRUN_TIMEOUT)
    pred = json.loads((DRYRUN_DIR / "predict.json").read_text())
    B, S = TRAIN_BATCH
    flops, recompute = train_flops(train_config_of(), B, S)
    steps = [(name, run, pred[name], MESH_RANKS)
             for name, run in measured.items()]
    steps.append((HEADS_NAME, heads["train"], pred[f"{HEADS_NAME}-train"],
                  HEADS_RANKS))
    for name, run, p, ranks in steps:
        calls, nbytes = p["collectives"]["calls"], p["collectives"]["bytes"]
        for s, h in enumerate(run["steps"]):
            if (h["calls"], h["bytes"]) != (calls, nbytes):
                fail(f"dry run {name}: step {s} made {h['calls']} "
                     f"collectives of {h['bytes']} B, predicted {calls} of "
                     f"{nbytes} B")
        res = p["memory"]["argument_bytes"] / run["resident"] - 1
        peak = p["memory"]["peak_bytes"] / run["peak"] - 1
        if abs(res) > DRYRUN_RESIDENT_RTOL or abs(peak) > DRYRUN_PEAK_RTOL:
            fail(f"dry run {name}: resident {p['memory']['argument_bytes']}"
                 f" B vs measured {run['resident']} ({res:+.3%}), peak "
                 f"{p['memory']['peak_bytes']} B vs {run['peak']} "
                 f"({peak:+.3%})")
        rl = p["roofline"]
        both = rl["flops_per_chip"] * ranks
        counted = ""
        if name in TRAIN_MESH_NAMES:        # train_flops counts granite's
            if abs(both / (flops + recompute) - 1) > DRYRUN_FLOPS_RTOL:
                fail(f"dry run {name}: {both} FLOP on both ranks vs "
                     f"train_flops' {flops + recompute}")
            counted = (f", equal to train_flops' "
                       f"{(flops + recompute) / 1e12:.4f} (forward + "
                       f"backward + recompute)")
        print(f"dry run of the {name} (data, model) step, rank 0 of "
              f"{ranks} fake ranks: {calls} collectives of "
              f"{nbytes / 1e9:.3f} GB {p['collectives']['payload_by_kind']}"
              f" equal the measured at every step; resident "
              f"{p['memory']['argument_bytes'] / 1e9:.3f} GB vs measured "
              f"{run['resident'] / 1e9:.3f} GB ({res:+.3%}); peak "
              f"{p['memory']['peak_bytes'] / 1e9:.3f} GB vs measured "
              f"{run['peak'] / 1e9:.3f} GB ({peak:+.3%}); "
              f"{rl['flops_per_chip'] / 1e12:.4f} TFLOP on rank 0, "
              f"{both / 1e12:.4f} on all {ranks} at rank 0's{counted}; "
              f"roofline "
              f"{rl['step_s']:.4f} s "
              f"({rl['bottleneck']}) at {rl['constants']['peak_flops']:.3g} "
              f"FLOP/s")
    for name, run in served.items():        # phase 10 (d)'s granite runs
        check_served(name, run, pred, MESH_RANKS)
    check_served(HEADS_NAME, heads["serve"], pred, HEADS_RANKS)
    wait_dryrun("production", runs["production"],
                DRYRUN_CELL_TIMEOUT - (time.perf_counter() - t0))
    rec = json.loads((DRYRUN_DIR / "production.json").read_text())
    rl, mem = rec["roofline"], rec["memory"]
    import torch
    print(f"dry run {rec['arch']} ({DRYRUN_CELL_LAYERS} of 40 layers) x "
          f"{rec['shape']} on the "
          f"{rec['chips']}-rank fake mesh {rec['mesh']} (torch "
          f"{torch.__version__}, {rec['wall_s']:.1f} s beside (a)): rank 0 {rl['flops_per_chip'] / 1e12:.1f} TFLOP, "
          f"{rl['hbm_bytes_per_chip'] / 1e9:.1f} GB HBM, collectives "
          f"{rec['collectives']['payload_by_kind']} B, peak "
          f"{mem['peak_bytes'] / 1e9:.2f} GB (fits 80 GB: "
          f"{rec['fits_hbm_80g']}), roofline compute {rl['compute_s']:.3f}"
          f" s, memory {rl['memory_s']:.3f} s, collective "
          f"{rl['collective_s']:.3f} s <- {rl['bottleneck']}; useful "
          f"FLOPs {rec['useful_flops_ratio']:.3f}")
    secs = time.perf_counter() - t0
    print(f"dry-run phase: (a) {pred['wall_s']:.1f} s, {secs:.1f} s with "
          f"(b); card {card_line()}")


def phase_clock(start: float):
    """A callable that prints one wall-time line per phase: the seconds
    since the previous call (or ``start``) and since ``start``."""
    last = [start]

    def done(name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - last[0]:.1f} s (wall {now - start:.1f} "
              f"s)")
        last[0] = now
    return done


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="granite-3-8b depth served (default: all 40)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-engine", action="store_true",
                    help="build and check the kernels only (prints no "
                         "result line)")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)       # phase 10 starts these
    ap.add_argument("--train-rank", type=int, default=None,
                    help=argparse.SUPPRESS)       # phase 11 starts these
    ap.add_argument("--heads-rank", type=int, default=None,
                    help=argparse.SUPPRESS)       # phase 10/11 (e) starts
    ap.add_argument("--dryrun-phase", choices=("predict", "production"),
                    help=argparse.SUPPRESS)       # phase 12 starts these
    args = ap.parse_args()
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank)
    if args.heads_rank is not None:
        return heads_rank(args.heads_rank)
    if args.train_rank is not None:
        return train_mesh_rank(args.train_rank)
    if args.dryrun_phase is not None:
        return dryrun_subprocess(args.dryrun_phase)
    start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    clock = phase_clock(start)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in "
          f"parallel)")
    clock("1 build")
    # one line per TPU kernel, in the order of PERF.md's table
    kernels = kernel_phase(torch, args.seed)
    head_shape_phase(torch, args.seed, kernels[2], kernels[3])
    clock("2 paged kernels")
    kernels.append(flash_kernel_phase(torch, args.seed))
    kernels.append(mla_kernel_phase(torch, args.seed))
    kernels += scan_kernel_phase(torch, args.seed)
    clock("2 flash, MLA and scan kernels")
    if args.skip_engine:                     # no main-path run: no result
        print(f"card: {card_line()}")
        return 0
    depths = tuner_phase(torch)
    clock("3 tuner")
    f32_runs = engine_phase(torch, args.layers, args.seed)
    gc.collect()                             # granite's weights go first
    torch.cuda.empty_cache()
    clock("4 granite f32")
    bf16_runs = bf16_engine_phase(torch, args.layers, args.seed, f32_runs)
    clock("4 granite bf16")
    launches = {kernel: n for kernel, n, _, _ in f32_runs.values()}
    ds32, ds32_tps, ds32_ref = deepseek_phase(torch, args.seed,
                                              torch.float32)
    clock("5 deepseek-v2 f32")
    ds16, ds16_tps, ds16_ref = deepseek_phase(torch, args.seed,
                                              torch.bfloat16)
    print(f"deepseek-v2 {DS_LAYERS} layers: bf16 {ds16_tps:.2f} tokens/s "
          f"(oracle {ds16_ref:.2f}), f32 {ds32_tps:.2f} tokens/s (oracle "
          f"{ds32_ref:.2f}); card {card_line()}")
    launches["mla_ctx"] = ds32 + ds16
    kernels[5]["bf16_launches"] = ds16
    clock("5 deepseek-v2 bf16")
    for name in HYBRID_LAYERS:
        for k, n in hybrid_phase(torch, name, args.seed).items():
            launches[k] = launches.get(k, 0) + n
        clock(f"6 {name}")
    danube = danube_attn_phase(torch, args.seed)
    launches["flash_attention"] += danube
    kernels[4]["bf16_launches"] = launches.pop("flash_attention bf16") + \
        danube
    clock("6 h2o-danube-3-4b attn_layer bf16")
    whisper_decode = encdec_phase(torch, args.seed)
    clock("7 whisper-small")
    for k, n in vision_phase(torch, args.seed).items():
        launches[k] += n
    clock("8 internvl2")
    oracle = training_phase(torch, args.seed)
    clock("9 training")
    scans, served = mesh_phase(torch, args.seed)
    for k, n in scans.items():               # phase 10 (d)'s, both ranks
        launches[k] += n
    clock("10 serving on a mesh")
    measured = train_mesh_phase(torch, args.seed, oracle)
    clock("11 training on a mesh")
    heads = heads_phase(torch, args.seed)
    clock("10/11 (e) uneven heads")
    dryrun_phase(measured, served, heads)
    clock("12 dry run")
    # the paged decode launches go to the row of the depth each model ran
    # (its key's tuned depth: row 2 at depth 1, row 3 at 2 and 4); the
    # split kernel (row 1) gets none.  The bf16 engine phase's launches
    # count there too, and again under bf16_launches
    from repro_torch.kernels.paged_attention import autotune
    kernels[0]["launches"] = kernels[1]["launches"] = 0
    kernels[2]["launches"] = 0
    bf16_decode = sum(n for k, n, _, _ in bf16_runs.values()
                      if k == "paged_decode")
    bf16_ragged = sum(n for k, n, _, _ in bf16_runs.values()
                      if k == "ragged")
    for n, key, dtype, bf16 in (
            (launches.pop("paged_decode"), (KV, HD, BS), torch.float32,
             False),
            (whisper_decode, (12, 64, BS), torch.float32, False),
            (bf16_decode, (KV, HD, BS), torch.bfloat16, True)):
        row = kernels[1 if depths[autotune.tuning_key(
            *key, dtype=dtype)] == 1 else 2]
        row["launches"] += n
        if bf16:
            row["bf16_launches"] += n
    launches["ragged"] += bf16_ragged
    kernels[3]["bf16_launches"] = bf16_ragged
    for i, name in enumerate(("ragged", "flash_attention", "mla_ctx",
                              "mamba_scan", "rwkv6_scan"), start=3):
        kernels[i]["launches"] = launches[name]
    print(f"card: {card_line()}")
    print(f"chip_smoke: wall time {time.perf_counter() - start:.1f} s (the "
          f"kernels' build included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
