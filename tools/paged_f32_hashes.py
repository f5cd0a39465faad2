"""sha256 of the attention kernels' f32 outputs on seeded cases, for one
checkout of the repository (``--root``, default the one holding this
script), so that two checkouts' f32 kernels can be compared bit for bit
on the same card:

    python tools/paged_f32_hashes.py [--root DIR] [--seed N]

The cases and the hashing are ``chip_smoke.f32_hashes`` of the checkout
holding this script: the paged decode kernel fused and over split pools
at granite-3-8b's heads, whisper-small's and a head of 120; the ragged
kernel split-K at heads of 128, 64 and 96, with and without a window;
flash attention at Jamba's widths (causal, S 4096), danube's (window
4096, S 6144, hd 120) and at hd 36; the MLA kernel at DeepSeek-V2's
widths with W 1 and 4 (8 splits a slot).  The kernels are those of
``DIR/src``, built into ``DIR/build``.  Prints the card's name and power
limit and one JSON line ``{"root": ..., "hashes": {case: sha256}}``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose kernels are hashed")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("paged_f32_hashes: needs a CUDA device")
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[2] != root:
        raise SystemExit(f"paged_f32_hashes: imported {repro_torch.__file__}"
                         f", not the package under {root}")
    print(f"card: {smoke.card_line()}")
    hashes = smoke.f32_hashes(torch, args.seed)
    print(json.dumps({"root": str(root), "hashes": hashes}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
