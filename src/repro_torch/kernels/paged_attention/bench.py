"""Where the paged-attention kernels spend their time, on the card.

Run from the root of a checkout on a machine with a CUDA device::

    PYTHONPATH=src python -m repro_torch.kernels.paged_attention.bench \
        [--dtype f32|bf16] [--q-dtype f32|bf16]

It first compiles ``csrc/paged_attention.cu`` with ``-Xptxas -v`` and
prints each kernel's registers and spills.  Then, at granite-3-8b's
attention shapes (KV 8, G 4, hd 128, bs 128, B 8, M 32), it times:

* the paged decode kernel at depth 2 on a skewed batch (slot 0 holds the
  full 4096-token table, the others random lengths, the last slot
  inactive) and on the same batch with every active slot at the mean
  length.  If the longest walk sets the time, the skewed time is about
  ``max / mean`` times the uniform one;
* the ragged kernel on chip_smoke.py's mixed batch of prefill chunks and
  decode rows, the same batch without its decode row at position 4095,
  and two of its rows alone: the decode row at 4095 (one query tile
  walking 4096 keys) and the 256-row chunk at 512.

``--dtype`` is the pool's element type and ``--q-dtype`` the queries'
(and the output's), each f32 unless given; the inputs are drawn in f32
from the same seed and rounded to them.  Each case is timed two ways with
CUDA events (median of 20): one eager wrapper call, host work included,
and one replay of a CUDA graph of the call, the device time of its
launches.  The last line is one JSON object of the times and the two
dtypes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention.ops import build_ragged_descriptor

KV, G, HD, BS, B, M = 8, 4, 128, 128, 8, 32
SEED = 0
#: chip_smoke.py's ragged timing batch as (slot, q_len, q_start); slot 5
#: is the decode row at 4095
RAGGED_ROWS = ((0, 300, 0), (1, 200, 256), (2, 77, 1024), (3, 1, 1999),
               (4, 1, 0), (5, 1, 4095), (6, 256, 512))
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def ptxas_report(src: Path = Path(pa.__file__).parent / "csrc" /
                 "paged_attention.cu") -> str:
    """nvcc's ``-Xptxas -v`` lines (registers, spills) for every kernel
    of a kernel source (the paged-attention one by default), built as the
    port builds it."""
    proc = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-c", "-Xptxas", "-v", "-o", os.devnull,
         str(src)], capture_output=True, text=True, check=True)
    return "\n".join(line for line in proc.stderr.splitlines()
                     if "Compiling entry" in line or "registers" in line
                     or "spill" in line)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def graph_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one replay of ``fn`` captured in a CUDA
    graph (the device time of its launches, without the host's work)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def decode_inputs(gen, dev, q_dtype, pool_dtype):
    N = B * M + 16
    kv_pool = torch.randn(N, BS, 2 * KV, HD, generator=gen,
                          device=dev).to(pool_dtype)
    q = torch.randn(B, KV, G, HD, generator=gen, device=dev).to(q_dtype)
    phys = torch.randperm(N, generator=gen, device=dev)[:B * M]
    tables = phys.reshape(B, M).to(torch.int32)
    lengths = torch.randint(1, M * BS + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = M * BS
    lengths[-1] = 0
    tables[-1] = -1
    return q, kv_pool, tables.reshape(1, B, M).contiguous(), lengths


def ragged_inputs(gen, dev, rows, q_dtype, pool_dtype):
    N = B * M + 16
    kv_pool = torch.randn(N, BS, 2 * KV, HD, generator=gen,
                          device=dev).to(pool_dtype)
    phys = torch.randperm(N, generator=gen, device=dev)[:B * M]
    tables = phys.reshape(B, M).to(torch.int32)
    for slot, qn, start in rows:
        tables[slot, -(-(start + qn) // BS):] = -1
    d = build_ragged_descriptor(
        [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
        [r[1] + r[2] for r in rows], num_slots=B, t_cap=B * 2 * BS)
    T = d["token_row"].shape[0]
    q = torch.randn(T, KV, G, HD, generator=gen, device=dev).to(q_dtype)
    desc = [torch.as_tensor(d[k], device=dev)
            for k in ("tile_row", "tile_pos", "kv_lens")]
    return q, kv_pool, tables.reshape(1, B, M).contiguous(), desc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=DTYPES, default="f32",
                    help="the pool's element type")
    ap.add_argument("--q-dtype", choices=DTYPES, default="f32",
                    help="the queries' (and the output's) element type")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    print(ptxas_report())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qd, pd = DTYPES[args.q_dtype], DTYPES[args.dtype]
    res = {"q_dtype": args.q_dtype, "dtype": args.dtype}
    q, pool, stack, lengths = decode_inputs(gen, dev, qd, pd)
    active = lengths > 0
    mean = int(lengths[active].float().mean().round().item())
    uniform = torch.where(active, torch.full_like(lengths, mean), lengths)
    for name, ln in (("decode_skewed", lengths), ("decode_uniform", uniform)):
        def fn(ln=ln):
            return pa.paged_attention_fused_fwd(q, pool, stack, ln,
                                                buffer_depth=2)
        res[name] = time_ms(fn)
        res[name + "_graph"] = graph_ms(fn)
    res["decode_lengths"] = lengths.tolist()
    res["decode_mean_length"] = mean
    for name, rows in (("ragged", RAGGED_ROWS),
                       ("ragged_no_4095", tuple(
                           r for r in RAGGED_ROWS if r[2] != 4095)),
                       ("ragged_only_4095", ((5, 1, 4095),)),
                       ("ragged_only_256_at_512", ((6, 256, 512),))):
        q, pool, stack, (trow, tpos, kvl) = ragged_inputs(gen, dev, rows,
                                                          qd, pd)

        def fn(q=q, pool=pool, stack=stack, trow=trow, tpos=tpos, kvl=kvl):
            return pa.ragged_fused_fwd(q, pool, stack, trow, tpos, kvl)
        res[name] = time_ms(fn)
        res[name + "_graph"] = graph_ms(fn)
    for k, v in res.items():
        print(f"{k}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
