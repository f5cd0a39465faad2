"""The ragged paged-attention kernel (``ragged_plan_kernel``,
``ragged_kernel``, and ``merge_kernel`` where a tile's keys split): every
slot's prefill-chunk and decode rows in one call per attention layer of
a ``ragged_step``."""

import numpy as np

#: the wrapper whose launches are this kernel's (module, attribute)
WRAPS = ("repro_torch.kernels.paged_attention.ops", "ragged_fused_fwd")
CALLS = "ragged_calls"


def layers(dims: dict) -> int:
    return dims["attn_layers"]


def work(desc: dict, dims: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's call from the step's descriptor:
    each real query token at position p attends keys 0 .. p (causal, no
    window); each slot's ``kv_lens`` keys are read once."""
    H, KV, hd = dims["heads"], dims["kv_heads"], dims["head_dim"]
    row, pos = desc["token_row"], desc["token_pos"]
    real = row >= 0
    pairs = float((pos[real].astype(np.int64) + 1).sum())
    slots = np.unique(row[real])
    keys = float(desc["kv_lens"][slots].astype(np.int64).sum())
    tokens = int(real.sum())
    flops = 4.0 * pairs * H * hd
    nbytes = (keys * 2 * KV * hd * dims["pool_bytes"]
              + 2 * tokens * H * hd * dims["act_bytes"]
              + tokens * 2 * 4 + len(slots) * (dims["table_cols"] + 1) * 4)
    return flops, nbytes
