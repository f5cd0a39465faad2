"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000; SWA window 4096.
head_dim = 3840/32 = 120.  The 4096-token window bounds decode KV reads, so
long_500k runs for this arch (ring-window mask over the paged cache).
"""

from repro_torch.models.config import AttnConfig, ModelConfig

SWA_WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
        n_kv_heads=8, d_ff=10240, vocab=32000, head_dim=120,
        attn=AttnConfig(window=SWA_WINDOW, rope_theta=10_000.0))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab=256, head_dim=16,
        attn=AttnConfig(window=32))
