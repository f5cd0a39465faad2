"""The paged-decode kernel (``paged_decode_kernel``, and ``merge_kernel``
where a slot's keys split): one query token a slot against its cached
keys and values, per attention layer of a ``decode_step``."""

from perfbench.work import resident_keys

#: the wrapper whose launches are this kernel's (module, attribute)
WRAPS = ("repro_torch.kernels.paged_attention.ops", "paged_attention_fused_fwd")
CALLS = "decode_calls"


def layers(dims: dict) -> int:
    return dims["attn_layers"]


def work(call, dims: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's call: ``call`` is the step's host
    tables (slots x blocks) and lengths (tokens cached before the step's
    token, which the call also attends)."""
    tables, lengths = call
    H, KV, hd = dims["heads"], dims["kv_heads"], dims["head_dim"]
    keys = active = 0
    for b in range(tables.shape[0]):
        if tables[b, 0] < 0:
            continue
        active += 1
        keys += resident_keys(tables, b, int(lengths[b]) + 1, dims["block"])
    flops = 4.0 * keys * H * hd
    nbytes = (keys * 2 * KV * hd * dims["pool_bytes"]
              + 2 * active * H * hd * dims["act_bytes"]
              + active * (tables.shape[1] + 1) * 4)
    return flops, nbytes
