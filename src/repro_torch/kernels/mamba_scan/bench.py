"""Where the selective-scan kernel spends its time, on the card.

Run from the root of a checkout on a machine with a CUDA device::

    PYTHONPATH=src python -m repro_torch.kernels.mamba_scan.bench

It first compiles ``csrc/mamba_scan.cu`` with ``-Xptxas -v`` and prints
each kernel's registers and spills.  Then, at Jamba's d_state (16), with
the model's dt = softplus(normal) and A = -exp(0.2·normal), it times
:func:`mamba_scan_fwd` on contiguous inputs:

* at B·DI = 16,384 (B 2, DI 8192) over S ∈ {512, 2000, 8192}: if the time
  is linear in S at a fixed width, the per-step work of the sequential
  loop sets it (µs per step = time / S);
* at S = 2000 over B·DI ∈ {8192, 16,384, 65,536} (B 1, 2, 8 of DI 8192):
  if the time stays flat while the work grows, the card is not full;
* ``ops.mamba_scan`` as the model calls it (B 2, S 2000): B and C are
  column views of the (B, S, R + 2N) ``x_proj`` output (R = 256), dt and
  x contiguous: the op's layout work and the kernel together.

Each case is timed two ways with CUDA events (median of 20): one eager
call, host work included, and one replay of a CUDA graph of the call,
the device time of its launches.  The last line is one JSON object of
the times.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan as msk
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.paged_attention.bench import (graph_ms,
                                                       ptxas_report, time_ms)

DI, N, R = 8192, 16, 256        # Jamba: d_inner, d_state, dt_rank
SEED = 0
#: (B, S) of the contiguous kernel cases
CASES = ((2, 512), (2, 2000), (2, 8192), (1, 2000), (8, 2000))


def inputs(gen, B, S, *, x_proj=False):
    """dt, A, B, C, x, h0 at (B, S, DI, N); with ``x_proj`` B and C are
    column views of one (B, S, R + 2N) tensor, as ``models.mamba`` makes
    them."""
    def randn(*sh):
        return torch.randn(*sh, generator=gen, device="cuda")
    dt = F.softplus(randn(B, S, DI))
    A = -torch.exp(0.2 * randn(DI, N))
    if x_proj:
        _, Bm, Cm = randn(B, S, R + 2 * N).split([R, N, N], dim=-1)
    else:
        Bm, Cm = randn(B, S, N), randn(B, S, N)
    return dt, A, Bm, Cm, randn(B, S, DI), randn(B, DI, N)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    print(ptxas_report(msk.SOURCE))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = {}
    for B, S in CASES:
        args = inputs(gen, B, S)

        def fn(args=args):
            return msk.mamba_scan_fwd(*args)
        name = f"kernel_B{B}_S{S}"
        res[name] = time_ms(fn)
        res[name + "_graph"] = graph_ms(fn)
        res[name + "_us_per_step_graph"] = 1e3 * res[name + "_graph"] / S
        del args
    args = inputs(gen, 2, 2000, x_proj=True)

    def op():
        return ops.mamba_scan(*args)
    res["op_B2_S2000"] = time_ms(op)
    res["op_B2_S2000_graph"] = graph_ms(op)
    for k, v in res.items():
        print(f"{k}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
