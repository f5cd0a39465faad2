"""ModelConfig — one declarative description drives all ten architectures.

A model is a stack of layers; each layer has a *mixer* (attn | mla | mamba |
rwkv6) and an *ffn* (dense | moe).  Layers are grouped into at most two
chunks for compilation: an optional irregular **prefix** (unrolled) and a
**periodic body** scanned with ``jax.lax.scan`` — e.g. Jamba's period-8
attn/mamba interleave scans 4 blocks of 8 sublayers; DeepSeek-V2's dense
first layer is the prefix and the 59 MoE layers scan.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int                 # routed experts
    top_k: int
    num_shared: int = 0              # DeepSeek shared experts (always on)
    d_expert: int = 0                # per-expert FFN width
    router_aux_coef: float = 0.001   # load-balance aux loss


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclass(frozen=True)
class AttnConfig:
    qkv_bias: bool = False           # qwen2.5
    window: int | None = None        # sliding-window (danube)
    rope_theta: float = 10_000.0
    rope: bool = True                # whisper uses learned positions instead


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # per-layer patterns; callables of layer index would not hash — store tuples
    mixers: tuple[str, ...] = ()     # len n_layers; 'attn'|'mla'|'mamba'|'rwkv6'
    ffns: tuple[str, ...] = ()       # len n_layers; 'dense'|'moe'
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mamba: MambaConfig | None = None
    attn: AttnConfig = field(default_factory=AttnConfig)
    # encoder-decoder (whisper): encoder is a dense-attn stack of enc_layers
    enc_dec: bool = False
    enc_layers: int = 0
    enc_len: int = 0                 # fixed encoder sequence (1500 frames)
    frontend: str | None = None      # 'audio' | 'vision' (STUB embeddings)
    prefix_tokens: int = 0           # vision prefix length (internvl)
    dense_d_ff: int | None = None    # d_ff of dense layers when mixed w/ MoE
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    max_position: int = 1 << 20

    def __post_init__(self):
        if not self.mixers:
            object.__setattr__(self, "mixers", ("attn",) * self.n_layers)
        if not self.ffns:
            object.__setattr__(self, "ffns", ("dense",) * self.n_layers)
        assert len(self.mixers) == self.n_layers
        assert len(self.ffns) == self.n_layers

    # ----------------------------------------------------------- layer schema
    def layer_sig(self, i: int) -> tuple[str, str]:
        return (self.mixers[i], self.ffns[i])

    def segmentation(self) -> tuple[int, int]:
        """Return (prefix_len, period): layers[:prefix] unroll, the rest scan
        in blocks of ``period`` sublayers."""
        sigs = [self.layer_sig(i) for i in range(self.n_layers)]
        for prefix in range(0, min(4, self.n_layers) + 1):
            body = sigs[prefix:]
            if not body:
                continue
            for period in range(1, min(8, len(body)) + 1):
                if len(body) % period:
                    continue
                if all(body[i] == body[i % period] for i in range(len(body))):
                    return prefix, period
        return self.n_layers, 0          # fully unrolled (shouldn't happen)

    # --------------------------------------------------------------- sizing
    @property
    def d_inner(self) -> int:        # mamba inner width
        return (self.mamba.expand if self.mamba else 2) * self.d_model

    def param_count(self) -> int:
        """Exact parameter count (used for 6·N·D roofline bookkeeping)."""
        return sum(t[1] for t in iter_param_shapes(self))

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k + shared experts)."""
        total = 0
        for name, n, active in iter_param_shapes(self, with_active=True):
            total += active
        return total

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def iter_param_shapes(cfg: ModelConfig, with_active: bool = False):
    """Yield (name, param_count[, active_count]) without allocating arrays.

    Mirrors models/transformer.py::init_params exactly (asserted in tests).
    """
    out = []

    def add(name, shape, active=None):
        n = _prod(shape)
        out.append((name, n, n if active is None else active))

    D, H, KV, HD, FF, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.vocab)
    add("embed", (V, D))
    if not cfg.tie_embeddings:
        add("unembed", (V, D))
    add("final_norm", (D,))
    if cfg.frontend == "vision":
        add("vision_proj", (D, D))
    if cfg.frontend == "audio":
        add("audio_proj", (D, D))

    def add_mixer(i, kind):
        p = f"layer{i}.{kind}"
        add(p + ".norm", (D,))
        if kind == "attn":
            add(p + ".wq", (D, H * HD))
            add(p + ".wk", (D, KV * HD))
            add(p + ".wv", (D, KV * HD))
            add(p + ".wo", (H * HD, D))
            if cfg.attn.qkv_bias:
                add(p + ".bq", (H * HD,))
                add(p + ".bk", (KV * HD,))
                add(p + ".bv", (KV * HD,))
        elif kind == "mla":
            m = cfg.mla
            qk_hd = m.nope_head_dim + m.rope_head_dim
            add(p + ".wq_a", (D, m.q_lora_rank))
            add(p + ".q_norm", (m.q_lora_rank,))
            add(p + ".wq_b", (m.q_lora_rank, H * qk_hd))
            add(p + ".wkv_a", (D, m.kv_lora_rank + m.rope_head_dim))
            add(p + ".kv_norm", (m.kv_lora_rank,))
            add(p + ".wkv_b", (m.kv_lora_rank,
                               H * (m.nope_head_dim + m.v_head_dim)))
            add(p + ".wo", (H * m.v_head_dim, D))
        elif kind == "mamba":
            mm = cfg.mamba
            DI = cfg.d_inner
            add(p + ".in_proj", (D, 2 * DI))
            add(p + ".conv_w", (mm.d_conv, DI))
            add(p + ".conv_b", (DI,))
            dt_rank = max(16, D // 16)
            add(p + ".x_proj", (DI, dt_rank + 2 * mm.d_state))
            add(p + ".dt_proj", (dt_rank, DI))
            add(p + ".A_log", (DI, mm.d_state))
            add(p + ".D", (DI,))
            add(p + ".out_proj", (DI, D))
        elif kind == "rwkv6":
            nH = D // 64
            hd = 64
            add(p + ".mu", (5, D))           # token-shift mixes (r,k,v,w,g)
            add(p + ".w_lora_a", (D, 64))
            add(p + ".w_lora_b", (64, D))
            add(p + ".wr", (D, D))
            add(p + ".wk", (D, D))
            add(p + ".wv", (D, D))
            add(p + ".wg", (D, D))
            add(p + ".u", (nH, hd))          # bonus
            add(p + ".ln_x", (2, D))         # per-head groupnorm scale/bias
            add(p + ".wo", (D, D))
        else:  # pragma: no cover
            raise ValueError(kind)

    def add_ffn(i, kind):
        p = f"layer{i}.{kind}"
        add(p + ".norm", (D,))
        if kind == "dense":
            dff = cfg.dense_d_ff or FF
            add(p + ".w_gate", (D, dff))
            add(p + ".w_up", (D, dff))
            add(p + ".w_down", (dff, D))
        else:
            mo = cfg.moe
            de = mo.d_expert or FF
            E = mo.num_experts
            add(p + ".router", (D, E))
            act_frac = mo.top_k / E
            for wname, shape in (("w_gate", (E, D, de)), ("w_up", (E, D, de)),
                                 ("w_down", (E, de, D))):
                add(p + "." + wname, shape, active=int(_prod(shape) * act_frac))
            if mo.num_shared:
                ds = de * mo.num_shared
                add(p + ".s_gate", (D, ds))
                add(p + ".s_up", (D, ds))
                add(p + ".s_down", (ds, D))

    for i in range(cfg.n_layers):
        mix, ffn = cfg.layer_sig(i)
        add_mixer(i, mix)
        add_ffn(i, ffn)

    if cfg.enc_dec:
        for i in range(cfg.enc_layers):
            add_mixer(f"enc{i}", "attn")
            add_ffn(f"enc{i}", "dense")
        for i in range(cfg.n_layers):       # cross-attention per decoder layer
            p = f"layer{i}.cross"
            add(p + ".norm", (D,))
            add(p + ".wq", (D, H * HD))
            add(p + ".wk", (D, KV * HD))
            add(p + ".wv", (D, KV * HD))
            add(p + ".wo", (H * HD, D))
        add("enc_pos", (cfg.enc_len, D))
        add("dec_pos", (4096, D))

    if with_active:
        return out
    return [(n, c) for n, c, _ in out]
