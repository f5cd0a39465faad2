"""internvl2-26b [vlm] — InternViT frontend (STUB) + InternLM2-20B backbone.
[arXiv:2404.16821; hf]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 (padded to 92672).
``input_specs`` provides 256 precomputed ViT patch embeddings per image as a
prefix; the vision tower itself is a stub projection.
"""

from repro_torch.models.config import AttnConfig, ModelConfig

VOCAB_RAW = 92553
PREFIX_TOKENS = 256


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=16384, vocab=92672, head_dim=128,
        frontend="vision", prefix_tokens=PREFIX_TOKENS,
        attn=AttnConfig(rope_theta=1_000_000.0))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab=256, head_dim=16,
        frontend="vision", prefix_tokens=8)
