"""whisper-small [audio] — encoder-decoder; conv frontend is a STUB.
[arXiv:2212.04356; unverified]

12L (decoder) d_model=768 12H (kv=12, MHA) d_ff=3072 vocab=51865 (padded to
51968).  12 encoder layers over 1500 precomputed frame embeddings
(``input_specs`` supplies frames; the conv tower is out of scope).  Learned
positions (no rope).  decode shapes exercise the paged self-KV cache +
immutable cross-KV; head_dim = 768/12 = 64.
"""

from repro_torch.models.config import AttnConfig, ModelConfig

VOCAB_RAW = 51865
ENC_LEN = 1500


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab=51968, head_dim=64,
        enc_dec=True, enc_layers=12, enc_len=ENC_LEN, frontend="audio",
        attn=AttnConfig(rope=False))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
        enc_dec=True, enc_layers=2, enc_len=32, frontend="audio",
        attn=AttnConfig(rope=False))
