"""qwen2.5-14b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""

from repro_torch.models.config import AttnConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=13824, vocab=152064, head_dim=128,
        attn=AttnConfig(qkv_bias=True, rope_theta=1_000_000.0))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab=256, head_dim=16,
        attn=AttnConfig(qkv_bias=True))
