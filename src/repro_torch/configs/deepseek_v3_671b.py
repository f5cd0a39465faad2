"""deepseek-v3-671b [moe] — MLA (kv_lora=512) + 1 shared + 256 routed top-8,
one chip's share of an 8-way expert-parallel layer.
[arXiv:2412.19437; hf deepseek-ai/DeepSeek-V3 config.json]

61L d_model=7168 128H d_expert=2048 vocab=129280.  Layers 0-2 dense
(d_ff=18432), 58 MoE layers.  The router is DeepSeek-V3's (sigmoid
scores, an aux-free correction bias, 8 groups of 32 experts scored by
their two best, the best 4 searched for the top 8, gates renormalised
and scaled by 2.5) over all 256 experts; this chip holds routing group
0, experts [0, 32), as one of the 8 chips an MoE layer is divided over.

The port alone has this architecture: it is registered in
``repro_torch/__init__.py``, outside ``configs.ARCH_IDS`` (a verbatim
copy of the reference's registry, whose ids the tests pair with the
reference's configs).
"""

from repro_torch.models.config import AttnConfig, MLAConfig
from repro_torch.models.moe_config import GroupRoutedMoE, HeldExpertsModel


def config() -> HeldExpertsModel:
    n_layers = 61
    return HeldExpertsModel(
        name="deepseek-v3-671b", n_layers=n_layers, d_model=7168,
        n_heads=128, n_kv_heads=128, d_ff=2048, vocab=129280, head_dim=128,
        mixers=("mla",) * n_layers,
        ffns=("dense",) * 3 + ("moe",) * (n_layers - 3),
        dense_d_ff=18432, norm_eps=1e-6,
        moe=GroupRoutedMoE(num_experts=32, top_k=8, num_shared=1,
                           d_expert=2048, routed_experts=256,
                           expert_groups=8, top_expert_groups=4,
                           routed_scale=2.5, held_first=0),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        attn=AttnConfig(rope_theta=10_000.0))


def smoke() -> HeldExpertsModel:
    """The same structure at CPU size: 2 dense then 2 MoE layers, 32
    experts routed over in 8 groups of 4, top-4 groups, top-8, the first
    group of 4 held."""
    n_layers = 4
    return HeldExpertsModel(
        name="deepseek-v3-671b-smoke", n_layers=n_layers, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=32, vocab=256, head_dim=16,
        mixers=("mla",) * n_layers, ffns=("dense",) * 2 + ("moe",) * 2,
        dense_d_ff=128, norm_eps=1e-6,
        moe=GroupRoutedMoE(num_experts=4, top_k=8, num_shared=1,
                           d_expert=32, routed_experts=32, expert_groups=8,
                           top_expert_groups=4, routed_scale=2.5,
                           held_first=0),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16))
