#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the FPR serving path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, any
of which fails the script:

1. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version at granite-3-8b
   attention shapes (KV=8, G=4, hd=128, bs=128, B=8, M=32): the paged
   decode kernel fused at depths 1, 2 and 4 (asserted bit-identical) and
   over split pools, with W in {1, 4}, holes and a sliding window; the
   ragged kernel on a mixed batch of unaligned prefill rows and decode
   rows.  Each kernel is timed with CUDA events beside its bound, its
   plain version and one PyTorch library call (SDPA on the gathered K/V,
   a yardstick the port never calls);
3. serve granite-3-8b at full width and depth (random f32 weights from a
   seeded generator) through the chunked path (decode through the paged
   decode kernel) and the ragged path (ragged kernel), each against the
   same engine with ``page_impl="ref"`` as the token oracle, and check
   the kernels' launch counts on those runs.

Prints the card's name and power limit, tokens/s per path, one
``{"kernels": [...]}`` JSON line and, last, ``{"ok": true, "device":
{...}}``.  Exits non-zero, printing no result, without a CUDA device or
without the rest of the repository beside it.
"""

from __future__ import annotations

import argparse
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
TOL = 2e-5                  # f32: kernel and plain version sum in other orders
PA = "src/repro/kernels/paged_attention/paged_attention.py"
CU = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"

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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


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


def decode_case(torch, gen, *, W, holes, window):
    dev = DEVICE
    N = B * M + 16
    kv_pool = torch.randn(N, BS, 2 * KV, HD, generator=gen, device=dev)
    q = torch.randn(B, KV, G, HD, generator=gen, device=dev)
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


def decode_work(c):
    """(visible K/V tokens over all heads' slots, bytes, flops) this case's
    data needs: each visible K/V row read once, q read, out written."""
    tables = c["tables"].cpu().numpy()
    tokens = 0
    for b, n in enumerate(c["lengths"].cpu().tolist()):
        lo = max(0, n - c["window"]) if c["window"] else 0
        for pos in range(lo, n):
            if tables[b, pos // BS] >= 0:
                tokens += 1
    nbytes = (tokens * KV * 2 * HD * 4 + 2 * B * KV * G * HD * 4
              + tables.size * 4 + B * 4)
    flops = tokens * KV * G * 4 * HD
    return tokens, nbytes, flops


def ragged_case(torch, gen, *, window):
    """Mixed batch: unaligned prefill chunks (one resuming mid-prompt),
    decode rows (one over a hole), an inactive slot; engine-like t_cap."""
    from repro_torch.kernels.paged_attention.ops import \
        build_ragged_descriptor
    dev = DEVICE
    #         slot, q_len, q_start
    rows = [(0, 300, 0), (1, 200, 256), (2, 77, 1024), (3, 1, 1999),
            (4, 1, 0), (5, 1, 4095), (6, 256, 512)]
    N = B * M + 16
    kv_pool = torch.randn(N, BS, 2 * KV, HD, generator=gen, device=dev)
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
    q = torch.randn(T, KV, G, HD, generator=gen, device=dev)
    t = {k: torch.as_tensor(d[k], device=dev)
         for k in ("token_row", "token_pos", "tile_row", "tile_pos",
                   "kv_lens")}
    return dict(q=q, kv_pool=kv_pool, tables=tables, window=window, **t)


def ragged_work(c):
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
    nbytes = (keys * KV * 2 * HD * 4 + 2 * real * KV * G * HD * 4
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
    qs = torch.zeros(len(slots), KV * G, tmax, HD, device=DEVICE)
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


def kernel_phase(torch, seed: int) -> list[dict]:
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    # ---- paged decode kernel: depths 1/2/4 and split, W, holes, window
    a_err = 0.0
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

    # timing at the engine's layout (W=1, holes, no window)
    c = decode_case(torch, gen, W=1, holes=True, window=None)
    q, pool, stack, lengths = c["q"], c["kv_pool"], c["stack"], c["lengths"]
    tokens, nbytes, flops = decode_work(c)
    b_ms, b_by = bound(nbytes, flops)
    plain_ms = time_ms(torch, lambda: ref.paged_decode_attention_fused_ref(
        q.reshape(B, KV * G, HD), pool, stack, lengths))
    lib_ms = time_ms(torch, sdpa_decode(torch, c))
    k_pool = pool[:, :, 0::2].contiguous()
    v_pool = pool[:, :, 1::2].contiguous()
    variants = []
    for name, replaces, fn in (
            ("fused depth 1", f"{PA}:239", lambda: pa.paged_attention_fused_fwd(
                q, pool, stack, lengths, buffer_depth=1)),
            ("fused depth 2", f"{PA}:352", lambda: pa.paged_attention_fused_fwd(
                q, pool, stack, lengths, buffer_depth=2)),
            ("fused depth 4", f"{PA}:352", lambda: pa.paged_attention_fused_fwd(
                q, pool, stack, lengths, buffer_depth=4)),
            ("split", f"{PA}:152", lambda: pa.paged_attention_fwd(
                q, k_pool, v_pool, stack, lengths))):
        ms = time_ms(torch, fn)
        variants.append(dict(name=name, replaces=replaces, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms))
        print(f"decode {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; "
              f"{tokens} visible K/V rows)")
    main = variants[1]
    a = dict(name="paged_decode_kernel", route="cuda", source=CU,
             replaces=f"{PA}:352", launches=0, max_abs_err=a_err,
             ms=main["ms"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, variants=variants)

    # ---- ragged kernel: mixed batch, real rows only, with and without window
    b_err = 0.0
    for window in (None, 700):
        c = ragged_case(torch, gen, window=window)
        o = pa.ragged_fused_fwd(c["q"], c["kv_pool"],
                                stack_tables(torch, c["tables"], 1),
                                c["tile_row"], c["tile_pos"], c["kv_lens"],
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
    c = ragged_case(torch, gen, window=None)
    stack = stack_tables(torch, c["tables"], 1)
    nbytes, flops = ragged_work(c)
    b_ms, b_by = bound(nbytes, flops)
    ms = time_ms(torch, lambda: pa.ragged_fused_fwd(
        c["q"], c["kv_pool"], stack, c["tile_row"], c["tile_pos"],
        c["kv_lens"]))
    plain_ms = time_ms(torch, lambda: ref.ragged_fused_ref(
        c["q"].reshape(-1, KV * G, HD), c["kv_pool"], c["tables"],
        c["token_row"], c["token_pos"], c["kv_lens"]), reps=5)
    lib_ms = time_ms(torch, sdpa_ragged(torch, c))
    print(f"ragged: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms)")
    b = dict(name="ragged_kernel", route="cuda", source=CU,
             replaces=f"{PA}:464", launches=0, max_abs_err=b_err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms)
    return [a, b]


# ----------------------------------------------------------- engine phase
PROMPT_LENS = (300, 2500, 777, 1503, 1029, 451, 2085, 1234)
NEW_TOKENS = 16


def serve(torch, cfg, params, *, ragged: bool, page_impl: str, seed: int):
    """One engine run; returns tokens by request, the snapshot, decode
    steps, seconds, each (request, token index)'s top-2 logit margin and
    the seconds of the device timeline spanned by each model entry point
    (CUDA events around each call, which neither block the host nor
    change the run; the rest is the device waiting on host work between
    calls)."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, params, config=EngineConfig(
        num_blocks=256, max_batch=8, max_seq_len=2560, admission="fcfs",
        chunked_prefill=True, prefill_chunk=2, ragged_kernel=ragged,
        page_impl=page_impl, device=DEVICE))
    rng = np.random.RandomState(seed)
    for i, n in enumerate(PROMPT_LENS):
        eng.submit(rng.randint(1, cfg.vocab, size=n),
                   max_new_tokens=NEW_TOKENS, stream=f"s{i % 2}",
                   group_id=i % 2 + 1)
    margins: dict = {}
    bad: list = []

    def record(logits, slots):
        top = torch.topk(logits, 2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).cpu().tolist()
        finite = torch.isfinite(logits).all(dim=-1).cpu().tolist()
        for slot, r in slots.items():
            margins[(r.rid, len(r.generated))] = gap[slot]
            if not finite[slot]:
                bad.append((r.rid, len(r.generated)))

    events: dict = {"prefill_chunk": [], "decode_step": [],
                    "ragged_step": []}

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
            mock.patch.object(tfm, "prefill_chunk", run["prefill_chunk"]):
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
    if len(toks) != len(PROMPT_LENS):
        fail(f"{len(toks)} of {len(PROMPT_LENS)} requests completed")
    out = (toks, eng.metrics.snapshot(), eng.decode_steps, secs, margins,
           spent)
    del eng
    torch.cuda.empty_cache()
    return out


def check_tokens(got, want, margins, what: str) -> None:
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        i = next(j for j in range(len(b)) if j >= len(a) or a[j] != b[j])
        m = margins.get((rid, i))
        print(f"{what}: request {rid} diverges at token {i} "
              f"(kernel {a[i] if i < len(a) else None}, oracle {b[i]}); "
              f"oracle top-2 margin {m}")
        if m is None or m >= 1e-3:
            fail(f"{what}: request {rid} diverges at token {i} with oracle "
                 f"margin {m} (not a near-tie)")


def engine_phase(torch, layers: int, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models import transformer as tfm

    cfg = get_config("granite-3-8b")
    if layers != cfg.n_layers:
        cfg = cfg.with_(n_layers=layers)
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=DEVICE).manual_seed(seed),
        device=DEVICE, dtype=torch.float32)
    torch.cuda.synchronize()
    print(f"granite-3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{tfm.param_count(params) / 1e9:.3f} B params f32, made in "
          f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    for ragged, kernel in ((False, "paged_decode"), (True, "ragged")):
        path = "ragged" if ragged else "chunked"
        pa.reset_launches()
        toks, snap, decode_steps, secs, _, spent = serve(
            torch, cfg, params, ragged=ragged, page_impl="kernel", seed=seed)
        counts = dict(pa.LAUNCHES)
        steps = (snap["engine.kernel.ragged_steps"] if ragged
                 else decode_steps)
        want = cfg.n_layers * steps
        other = "paged_decode" if ragged else "ragged"
        if counts[kernel] != want or counts[other] != 0:
            fail(f"{path} path launches {counts}, expected {kernel} = "
                 f"{cfg.n_layers} layers x {steps} steps = {want}")
        if ragged and snap["engine.kernel.kernel_calls"] != want:
            fail(f"ragged kernel_calls {snap['engine.kernel.kernel_calls']}"
                 f" != {want}")
        if snap["engine.prefill_chunk_traces"] != 1:
            fail(f"{path}: {snap['engine.prefill_chunk_traces']} chunk "
                 f"shape signatures, expected 1")
        launches[kernel] = counts[kernel]
        ref_toks, _, _, ref_secs, margins, _ = serve(
            torch, cfg, params, ragged=ragged, page_impl="ref", seed=seed)
        check_tokens(toks, ref_toks, margins, path)
        n = sum(len(t) for t in toks.values())
        print(f"engine {path}: {n} tokens, kernel {n / secs:.2f} tokens/s "
              f"({secs:.2f} s), oracle {n / ref_secs:.2f} tokens/s "
              f"({ref_secs:.2f} s); {kernel} launches {counts[kernel]} = "
              f"{cfg.n_layers} x {steps} steps; tokens match the oracle")
        split = ", ".join(f"{k} {v:.2f} s" for k, v in spent.items() if v)
        print(f"engine {path} kernel run, device time spanned: {split}, "
              f"rest {secs - sum(spent.values()):.2f} s")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="granite-3-8b depth served (default: all 40)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-engine", action="store_true",
                    help="build and check the kernels only (prints no "
                         "result line)")
    args = ap.parse_args()
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
        from repro_torch.kernels.paged_attention import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build(pa._SOURCES)
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    kernels = kernel_phase(torch, args.seed)
    if args.skip_engine:                     # no main-path run: no result
        print(f"card: {card_line()}")
        return 0
    launches = engine_phase(torch, args.layers, args.seed)
    kernels[0]["launches"] = launches["paged_decode"]
    kernels[1]["launches"] = launches["ragged"]
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
