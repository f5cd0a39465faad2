"""rwkv6-7b [ssm] — "Finch", attention-free, data-dependent decay.
[arXiv:2404.05892; hf]

32L d_model=4096 d_ff=14336 vocab=65536.  No KV cache exists: decode state is
a constant-size per-head (64×64) WKV accumulator + token-shift buffer, so KV
paging — and therefore FPR — is inapplicable to this arch (recorded in
DESIGN.md §Arch-applicability).  The arch still runs through the same engine
with a recycled state-pool.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    n_layers = 32
    return ModelConfig(
        name="rwkv6-7b", n_layers=n_layers, d_model=4096, n_heads=64,
        n_kv_heads=64, d_ff=14336, vocab=65536, head_dim=64,
        mixers=("rwkv6",) * n_layers)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke", n_layers=2, d_model=128, n_heads=2,
        n_kv_heads=2, d_ff=256, vocab=256, head_dim=64,
        mixers=("rwkv6",) * 2)
