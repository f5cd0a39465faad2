"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]

28L d_model=2048 16H (kv=16) d_expert=1408 vocab=102400; layer 0 is dense
(d_ff=10944), layers 1..27 are MoE — the DeepSeekMoE layout.
"""

from repro_torch.models.config import AttnConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    n_layers = 28
    return ModelConfig(
        name="deepseek-moe-16b", n_layers=n_layers, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=102400, head_dim=128,
        mixers=("attn",) * n_layers,
        ffns=("dense",) + ("moe",) * (n_layers - 1),
        dense_d_ff=10944,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
        attn=AttnConfig(rope_theta=10_000.0))


def smoke() -> ModelConfig:
    n_layers = 3
    return ModelConfig(
        name="deepseek-moe-16b-smoke", n_layers=n_layers, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=48, vocab=256, head_dim=16,
        mixers=("attn",) * n_layers, ffns=("dense",) + ("moe",) * 2,
        dense_d_ff=128,
        moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, d_expert=48))
