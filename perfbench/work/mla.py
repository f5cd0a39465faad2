"""The MLA decode kernel (``mla_ctx_kernel``, and ``mla_merge_kernel``
where a slot's pages split): absorbed queries (f32, ``rank`` + ``rope``
wide a head) against the paged latents and rope keys, per MLA layer of a
``decode_step``; the output is the f32 latent context."""

from perfbench.work import resident_keys

#: the wrapper whose launches are this kernel's (module, attribute)
WRAPS = ("repro_torch.kernels.mla_attention.ops", "mla_paged_ctx_fwd")
CALLS = "decode_calls"


def layers(dims: dict) -> int:
    return dims["mla_layers"]


def work(call, dims: dict) -> tuple[float, float]:
    tables, lengths = call
    H, rank, rope = dims["heads"], dims["rank"], dims["rope"]
    keys = active = 0
    for b in range(tables.shape[0]):
        if tables[b, 0] < 0:
            continue
        active += 1
        keys += resident_keys(tables, b, int(lengths[b]) + 1, dims["block"])
    flops = keys * H * (2.0 * (rank + rope) + 2.0 * rank)
    nbytes = (keys * (rank + rope) * dims["pool_bytes"]
              + active * H * (2 * rank + rope) * 4
              + active * (tables.shape[1] + 1) * 4)
    return flops, nbytes
