"""Seconds per greedy ``decode_step`` of the port's decode paths on one
CUDA card, for one checkout of the repository (``--root``, default the
one holding this script), so that two checkouts can be timed back to
back on the same card: run it once a checkout, alternating (parent,
change, change, parent), and compare only runs made together.

    python tools/decode_timing.py [--root DIR] [--steps N] [--runs A,B]
                                  [--out FILE]

Each model is made from a seed in f32 at its published widths (depth
cut where named), prefills a batch of 2 prompts, then runs ``--steps``
greedy decode steps, each timed on the host clock between two
``torch.cuda.synchronize`` calls (these steps are bound by the host's
kernel launches).  Runs:

    granite-kernel   granite-3-8b, 8 of 40 layers, 2 x 1000 prompt,
                     page_impl="kernel" (the CUDA paged-decode kernel)
    granite-ref      the same, page_impl="ref" (the torch-eager oracle)
    whisper          whisper-small whole, 2 x 200 with frames, "kernel"
    internvl2        InternVL2-26B, 16 of 48 layers, 256-token vision
                     prefix + 2 x 300, "kernel"
    rwkv6            RWKV-6-7B, 8 of 32 layers, 2 x 1000: no paged pool,
                     so no cache write (the control)

Prints the torch build, the card's name and power limit, and one JSON
line ``{"root": ..., "runs": {run: {"median_s", "mean_s", "steps_s"}}}``
(also written to ``--out``).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUNS = {  # name: (arch, layers or None, (B, S), page_impl, extra input)
    "granite-kernel": ("granite-3-8b", 8, (2, 1000), "kernel", None),
    "granite-ref": ("granite-3-8b", 8, (2, 1000), "ref", None),
    "whisper": ("whisper-small", None, (2, 200), "kernel", "frames"),
    "internvl2": ("internvl2-26b", 16, (2, 300), "kernel", "patches"),
    "rwkv6": ("rwkv6-7b", 8, (2, 1000), "kernel", None),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def time_run(torch, tfm, get_config, run, steps: int, seed: int) -> list:
    arch, layers, (B, S), page_impl, extra = run
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.with_(n_layers=layers, mixers=cfg.mixers[:layers],
                        ffns=cfg.ffns[:layers])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = tfm.init_params(cfg, generator=gen, device="cuda",
                             dtype=torch.float32)
    prompts = torch.randint(1, cfg.vocab, (B, S), generator=gen,
                            device="cuda", dtype=torch.int32)
    kw = {}
    if extra == "frames":
        kw["enc_frames"] = torch.randn(B, cfg.enc_len, cfg.d_model,
                                       generator=gen, device="cuda")
    elif extra == "patches":
        kw["patches"] = torch.randn(B, cfg.prefix_tokens, cfg.d_model,
                                    generator=gen, device="cuda")
    total = S + (cfg.prefix_tokens if extra == "patches" else 0)
    st = tfm.init_decode_state(cfg, B, total + steps + 1,
                               dtype=torch.float32, device="cuda")
    secs = []
    with torch.no_grad():
        lg, st = tfm.prefill(params, cfg, prompts, st, impl="chunked", **kw)
        tok = lg.argmax(-1).to(torch.int32)
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, st = tfm.decode_step(params, cfg, st, tok,
                                     page_impl=page_impl)
            tok = lg.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    if not torch.isfinite(lg).all():
        raise SystemExit(f"{arch}: non-finite logits")
    del params, st
    gc.collect()
    torch.cuda.empty_cache()
    return secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="comma-separated names of RUNS (default: all)")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_timing: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tfm
    if not Path(tfm.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"repro_torch imported from {tfm.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    print(f"torch {torch.__version__}, card {card_line()}, root {root}")
    out = {}
    for name in args.runs.split(","):
        secs = time_run(torch, tfm, get_config, RUNS[name], args.steps,
                        args.seed)
        out[name] = {"median_s": statistics.median(secs),
                     "mean_s": statistics.fmean(secs), "steps_s": secs}
        print(f"{name}: median {out[name]['median_s'] * 1e3:.3f} ms a step, "
              f"mean {out[name]['mean_s'] * 1e3:.3f} ms", flush=True)
    line = json.dumps({"root": str(root), "runs": out})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
