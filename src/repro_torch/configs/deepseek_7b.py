"""deepseek-7b [dense] — llama-arch MHA. [arXiv:2401.02954; hf]

30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400.
"""

from repro_torch.models.config import AttnConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32,
        n_kv_heads=32, d_ff=11008, vocab=102400, head_dim=128,
        attn=AttnConfig(rope_theta=10_000.0))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab=256, head_dim=16)
