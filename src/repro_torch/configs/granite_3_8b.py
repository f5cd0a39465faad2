"""granite-3-8b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155 (padded to 49408 for
16-way TP divisibility; padding rows carry -inf-free zero logits).
"""

from repro_torch.models.config import AttnConfig, ModelConfig

VOCAB_RAW = 49155


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=12800, vocab=49408, head_dim=128,
        attn=AttnConfig(rope_theta=10_000.0), tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab=256, head_dim=16, tie_embeddings=True)
