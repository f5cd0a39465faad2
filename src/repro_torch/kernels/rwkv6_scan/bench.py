"""Where the RWKV-6 WKV kernel spends its time, on the card.

Run from the root of a checkout on a machine with a CUDA device::

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6_scan.bench

It first compiles ``csrc/rwkv6_scan.cu`` with ``-Xptxas -v`` and prints
each kernel's registers and spills.  Then, at RWKV-6-7B's head size (64),
with the decays ``w = exp(-exp(0.5·normal - 0.5))`` of ``chip_smoke.py``,
it times :func:`rwkv6_scan_fwd` on heads-major contiguous inputs:

* at B·nH = 128 (B 2, 64 heads) over S ∈ {512, 2016, 8192}: if the time
  grows with S at a fixed width, the serial chain over the sequence sets
  it;
* at S = 2016 over B·nH ∈ {32, 128, 512} (B 1/2/8 of 32/64/64 heads): if
  the time stays flat while the work grows fourfold, the card is not full;
* ``ops.rwkv6_scan`` as the model calls it, token-major (B 2, S 2000, 64
  heads): the op's layout work and the kernel together;
* where the wrapper has a ``_COL_SPLIT`` (blocks per head), the kernel at
  B 2, 64 heads, S 2016 with each of 1, 2 and 4, and with strong decays
  (half the heads' log w times 4, down to -5: their chunks take the
  sequential slow path).

Each case is timed two ways with CUDA events (median of 20): one eager
call, host work included, and one replay of a CUDA graph of the call,
the device time of its launches.  The last line is one JSON object of
the times.
"""

from __future__ import annotations

import json
from unittest import mock

import torch

from repro_torch.kernels.paged_attention.bench import (graph_ms,
                                                       ptxas_report, time_ms)
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rk

HD = 64
SEED = 0
#: (B, nH, S) of the heads-major kernel cases
CASES = ((2, 64, 512), (2, 64, 2016), (2, 64, 8192), (1, 32, 2016),
         (8, 64, 2016))


def inputs(gen, shape, nH):
    """r, k, v, w of ``shape`` and u, S0 for nH heads of HD."""
    def randn(*sh):
        return torch.randn(*sh, generator=gen, device="cuda")
    B = shape[0]
    return (randn(*shape), randn(*shape), randn(*shape),
            torch.exp(-torch.exp(0.5 * randn(*shape) - 0.5)),
            0.1 * randn(nH, HD), 0.1 * randn(B, nH, HD, HD))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    print(ptxas_report(rk.SOURCE))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = {}
    for B, nH, S in CASES:
        args = inputs(gen, (B, nH, S, HD), nH)

        def fn(args=args):
            return rk.rwkv6_scan_fwd(*args)
        name = f"kernel_B{B}_nH{nH}_S{S}"
        res[name] = time_ms(fn)
        res[name + "_graph"] = graph_ms(fn)
        del args
    args = inputs(gen, (2, 2000, 64, HD), 64)

    def op():
        return ops.rwkv6_scan(*args)
    res["op_B2_S2000_nH64"] = time_ms(op)
    res["op_B2_S2000_nH64_graph"] = graph_ms(op)
    if hasattr(rk, "_COL_SPLIT"):
        args = inputs(gen, (2, 64, 2016, HD), 64)
        for cs in (1, 2, 4):
            def fn():
                return rk.rwkv6_scan_fwd(*args)
            with mock.patch.object(rk, "_COL_SPLIT", cs):
                res[f"kernel_col_split{cs}"] = time_ms(fn)
                res[f"kernel_col_split{cs}_graph"] = graph_ms(fn)
        logw = torch.log(args[3])
        logw[:, ::2] = (4 * logw[:, ::2]).clamp(min=-5.0)
        strong = (*args[:3], torch.exp(logw), *args[4:])
        res["kernel_strong_decay"] = time_ms(lambda: rk.rwkv6_scan_fwd(*strong))
        res["kernel_strong_decay_graph"] = graph_ms(
            lambda: rk.rwkv6_scan_fwd(*strong))
    for k, v in res.items():
        print(f"{k}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
