"""Where the flash-attention forward kernel spends its time, on the card.

Run from the root of a checkout on a machine with a CUDA device::

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bench \
        [--dtype f32|bf16] [--q-dtype f32|bf16]

It first compiles ``csrc/flash_attention.cu`` with ``-Xptxas -v`` and
prints each kernel's registers and spills.  Then it times
:func:`flash_attention_fwd` on heads-major contiguous inputs:

* Jamba's attention (B 1, H 32, KV 8, hd 128), causal, over S ∈ {1024,
  4096, 8192}: the work grows as S², so the time should too;
* h2o-danube-3-4b's (S 6144, H 32, KV 8, hd 120, window 4096);
* Jamba's widths at S 4096, not causal (twice the causal work);
* ``ops.flash_attention`` as the model calls it, on (B, S, H, hd)
  tensors (Jamba, causal, S 4096): the op's layout work and the kernel.

``--dtype`` is k's and v's element type and ``--q-dtype`` q's (and the
output's), each f32 unless given; the inputs are drawn in f32 from the
same seed and rounded to them.  Each case is timed two ways with CUDA
events (median of 20): one eager call, host work included, and one
replay of a CUDA graph of the call, the device time of its launches;
with the achieved TFLOP/s (4·hd flops a visible (query, key) pair) of
the replay against the f32 CUDA-core peak (67) and the 3xTF32
tensor-core peak (495 / 3).  The last line is one JSON object of the
times and the two dtypes.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels.flash_attention import flash_attention as fak
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.paged_attention.bench import (DTYPES, graph_ms,
                                                       ptxas_report, time_ms)

SEED = 0
PEAK_F32, PEAK_3XTF32 = 67.0, 495.0 / 3       # TFLOP/s, H100 SXM
#: name → (B, S, H, KV, hd, causal, window)
CASES = {"jamba_causal_S1024": (1, 1024, 32, 8, 128, True, None),
         "jamba_causal_S4096": (1, 4096, 32, 8, 128, True, None),
         "jamba_causal_S8192": (1, 8192, 32, 8, 128, True, None),
         "danube_window_S6144": (1, 6144, 32, 8, 120, True, 4096),
         "jamba_full_S4096": (1, 4096, 32, 8, 128, False, None)}


def flops(B, S, H, hd, causal, window) -> float:
    """4·hd flops for every visible (query, key) pair."""
    if not causal:
        pairs = S * S
    else:
        w = window or S
        pairs = sum(min(i + 1, w) for i in range(S))
    return 4.0 * hd * pairs * H * B


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=DTYPES, default="f32",
                    help="k's and v's element type")
    ap.add_argument("--q-dtype", choices=DTYPES, default="f32",
                    help="q's (and the output's) element type")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    print(ptxas_report(fak.SOURCE))
    qd, kd = DTYPES[args.q_dtype], DTYPES[args.dtype]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = {"q_dtype": args.q_dtype, "dtype": args.dtype}
    for name, (B, S, H, KV, hd, causal, window) in CASES.items():
        def randn(*sh, dtype):
            return torch.randn(*sh, generator=gen, device="cuda").to(dtype)
        q, k, v = (randn(B, H, S, hd, dtype=qd),
                   randn(B, KV, S, hd, dtype=kd),
                   randn(B, KV, S, hd, dtype=kd))

        def fn(q=q, k=k, v=v, causal=causal, window=window):
            return fak.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
        res[name] = time_ms(fn)
        res[name + "_graph"] = g = graph_ms(fn)
        tf = flops(B, S, H, hd, causal, window) / g / 1e9
        res[name + "_tflops_graph"] = tf
        res[name + "_share_f32"] = tf / PEAK_F32
        res[name + "_share_3xtf32"] = tf / PEAK_3XTF32
        del q, k, v
    B, S, H, KV, hd, _, _ = CASES["jamba_causal_S4096"]
    q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda").to(d)
               for n, d in ((H, qd), (KV, kd), (KV, kd)))

    def op():
        return ops.flash_attention(q, k, v, causal=True)
    res["op_jamba_causal_S4096"] = time_ms(op)
    res["op_jamba_causal_S4096_graph"] = graph_ms(op)
    for k_, v_ in res.items():
        print(f"{k_}: {v_}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
