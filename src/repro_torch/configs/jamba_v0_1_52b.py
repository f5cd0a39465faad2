"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE every other
layer (16 experts, top-2). [arXiv:2403.19887; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Period-8 blocks:
attention at in-block offset 4 (1 attn : 7 mamba), MoE on odd offsets.
Attention layers carry no positional encoding (Mamba provides order).
"""

from repro_torch.models.config import (AttnConfig, MambaConfig, ModelConfig,
                                 MoEConfig)


def _patterns(n_layers: int):
    mixers = tuple("attn" if i % 8 == 4 else "mamba" for i in range(n_layers))
    ffns = tuple("moe" if i % 2 == 1 else "dense" for i in range(n_layers))
    return mixers, ffns


def config() -> ModelConfig:
    n_layers = 32
    mixers, ffns = _patterns(n_layers)
    return ModelConfig(
        name="jamba-v0.1-52b", n_layers=n_layers, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=65536, head_dim=128,
        mixers=mixers, ffns=ffns,
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        attn=AttnConfig(rope=False))


def smoke() -> ModelConfig:
    n_layers = 8                       # one full period
    mixers, ffns = _patterns(n_layers)
    return ModelConfig(
        name="jamba-v0.1-52b-smoke", n_layers=n_layers, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab=256, head_dim=16,
        mixers=mixers, ffns=ffns,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=96),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        attn=AttnConfig(rope=False))
