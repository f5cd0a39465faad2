"""Where the absorbed-MLA paged decode kernel spends its time, on the card.

Run from the root of a checkout on a machine with a CUDA device::

    PYTHONPATH=src python -m repro_torch.kernels.mla_attention.bench \
        [--dtype f32|bf16] [--q-dtype f32|bf16]

It first compiles ``csrc/mla_attention.cu`` with ``-Xptxas -v`` and prints
each kernel's registers and spills.  Then, at DeepSeek-V2's widths (H 128,
rank 512, rope 64, bs 128, B 8, M 16), it times :func:`mla_paged_ctx_fwd`
on ``chip_smoke.py``'s skewed batch (slot 0 holds the full 2048-token
table, the others random lengths with holes in the odd slots, the last
slot of length 0) and on the same batch with every active slot at the
mean length.  If the longest walk sets the time, the skewed time is about
``max / mean`` times the uniform one.  A wrapper with a ``_MAX_HG`` cap on
the heads per CTA (the kernel before the split-K redesign) is timed at
each count in :data:`HEADS_PER_CTA` that it takes (it raises on the
others, which are skipped); one with a fixed ``HEADS_PER_CTA`` at that.

``--dtype`` is the pools' element type and ``--q-dtype`` the queries',
each f32 unless given (the decode path hands the kernel f32 queries);
the inputs are drawn in f32 from the same seed and rounded to them, and
the context is f32 either way.  Each case is timed two ways with CUDA
events (median of 20): one eager call, host work included, and one
replay of a CUDA graph of the call, the device time of its launches.
The last line is one JSON object of the times and the two dtypes.
"""

from __future__ import annotations

import argparse
import json
from contextlib import nullcontext
from unittest import mock

import torch

from repro_torch.kernels.paged_attention.bench import (DTYPES, graph_ms,
                                                       ptxas_report, time_ms)
from repro_torch.kernels.mla_attention import mla_attention as mk

H, RANK, ROPE, BS, B, M = 128, 512, 64, 128, 8, 16
SCALE = (128 + ROPE) ** -0.5
SEED = 0
#: heads per CTA to try where the wrapper's cap ``_MAX_HG`` can be set
HEADS_PER_CTA = (4, 8, 16, 32, 64)


def skewed_inputs(gen, q_dtype=torch.float32, pool_dtype=torch.float32):
    """chip_smoke.py's MLA timing case (W = 1), queries and pools rounded
    to their dtypes."""
    dev = "cuda"
    N = B * M + 16
    phys = torch.randperm(N, generator=gen, device=dev)[:B * M]
    tables = phys.reshape(B, M).to(torch.int32)
    lengths = torch.randint(1, M * BS + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = M * BS
    lengths[-1] = 0
    for b in range(1, B - 1, 2):
        tables[b, [1, 3, 7]] = -1
    return (torch.randn(B, H, RANK, generator=gen, device=dev).to(q_dtype),
            torch.randn(B, H, ROPE, generator=gen, device=dev).to(q_dtype),
            torch.randn(N, BS, RANK, generator=gen, device=dev).to(pool_dtype),
            torch.randn(N, BS, ROPE, generator=gen, device=dev).to(pool_dtype),
            tables.reshape(1, B, M).contiguous(), lengths)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=DTYPES, default="f32",
                    help="the pools' element type")
    ap.add_argument("--q-dtype", choices=DTYPES, default="f32",
                    help="the queries' element type")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    print(ptxas_report(mk.SOURCE))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    *head, lengths = skewed_inputs(gen, DTYPES[args.q_dtype],
                                   DTYPES[args.dtype])
    active = lengths > 0
    mean = int(lengths[active].float().mean().round().item())
    uniform = torch.where(active, torch.full_like(lengths, mean), lengths)
    res = {"q_dtype": args.q_dtype, "dtype": args.dtype,
           "lengths": lengths.tolist(), "mean_length": mean}
    capped = hasattr(mk, "_MAX_HG")
    for hg in HEADS_PER_CTA if capped else (mk.HEADS_PER_CTA,):
        for name, ln in (("skewed", lengths), ("uniform", uniform)):
            def fn(ln=ln):
                return mk.mla_paged_ctx_fwd(*head, ln, scale=SCALE)
            key = f"{name}_hg{hg}"
            with (mock.patch.object(mk, "_MAX_HG", hg) if capped
                  else nullcontext()):
                try:
                    fn()
                    torch.cuda.synchronize()
                except (RuntimeError, ValueError) as e:
                    print(f"{key}: not taken ({e})")
                    continue
                res[key] = time_ms(fn)
                res[key + "_graph"] = graph_ms(fn)
    for k, v in res.items():
        print(f"{k}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
