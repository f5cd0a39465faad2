"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the full-size ModelConfig; ``get_smoke(arch_id)``
returns a reduced same-family config for CPU smoke tests.  ``SHAPES`` defines
the assigned input-shape set shared by every LM arch.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

ARCH_IDS = (
    "jamba-v0.1-52b",
    "whisper-small",
    "internvl2-26b",
    "deepseek-v2-236b",
    "deepseek-moe-16b",
    "deepseek-7b",
    "granite-3-8b",
    "h2o-danube-3-4b",
    "qwen2.5-14b",
    "rwkv6-7b",
)

_MODULE_OF = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
              for a in ARCH_IDS}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: Archs allowed to run long_500k (sub-quadratic or bounded-window decode).
#: Pure full-attention archs skip it per the assignment and DESIGN.md.
LONG_CONTEXT_ARCHS = {"jamba-v0.1-52b", "rwkv6-7b", "h2o-danube-3-4b"}


def get_config(arch_id: str):
    mod = importlib.import_module(_MODULE_OF[arch_id])
    return mod.config()


def get_smoke(arch_id: str):
    mod = importlib.import_module(_MODULE_OF[arch_id])
    return mod.smoke()


def cells(multi_pod: bool = False):
    """Yield every (arch, shape) dry-run cell, honouring long_500k skips."""
    for a in ARCH_IDS:
        for s in SHAPES.values():
            if s.name == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                continue
            yield a, s
