"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

60L d_model=5120 128H d_expert=1536 vocab=102400.  Layer 0 dense (d_ff=12288),
59 MoE layers.  MLA pages store rank-512 latents + 64-dim rope keys — ~9×
smaller than GQA pages, so they recycle ~9× faster (FPR's best case).
"""

from repro_torch.models.config import (AttnConfig, MLAConfig, ModelConfig,
                                 MoEConfig)


def config() -> ModelConfig:
    n_layers = 60
    return ModelConfig(
        name="deepseek-v2-236b", n_layers=n_layers, d_model=5120,
        n_heads=128, n_kv_heads=128, d_ff=1536, vocab=102400, head_dim=128,
        mixers=("mla",) * n_layers,
        ffns=("dense",) + ("moe",) * (n_layers - 1),
        dense_d_ff=12288,
        moe=MoEConfig(num_experts=160, top_k=6, num_shared=2, d_expert=1536),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        attn=AttnConfig(rope_theta=10_000.0))


def smoke() -> ModelConfig:
    n_layers = 3
    return ModelConfig(
        name="deepseek-v2-236b-smoke", n_layers=n_layers, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=48, vocab=256, head_dim=16,
        mixers=("mla",) * n_layers, ffns=("dense",) + ("moe",) * 2,
        dense_d_ff=128,
        moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, d_expert=48),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16))
