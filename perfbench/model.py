"""The system under test: the port's model config, its weights made from
the seed, and its serving engine.

The port's ``ModelConfig`` comes from ``repro_torch.configs`` by the
configuration file's ``port.arch``, cut to the file's
``num_hidden_layers`` and given its ``rms_norm_eps``;
:func:`check_config` holds every width of the file against it, so the
program runs the configuration the file states.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BLOCK = 128                 # tokens a KV block (the port's BLOCK_SIZE)

#: leaves set to one; leaves drawn at 0.02; other 1-D leaves are zero
ONES = ("norm", "q_norm", "kv_norm", "final_norm")
EMBEDS = ("embed", "unembed")


def port_config(config: dict, smoke: bool = False):
    """The port's ModelConfig of a configuration file (``smoke``: the
    arch's CPU smoke config, for tests)."""
    from repro_torch.configs import get_config, get_smoke
    arch = config["port"]["arch"]
    if smoke:
        return get_smoke(arch)
    full = get_config(arch)
    n = int(config["num_hidden_layers"])
    cfg = full.with_(n_layers=n, mixers=full.mixers[:n], ffns=full.ffns[:n],
                     norm_eps=float(config["rms_norm_eps"]))
    check_config(config, cfg)
    return cfg


def check_config(config: dict, cfg) -> None:
    """Raise where the port's config departs from a width or count of the
    configuration file."""
    want = {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_hidden_layers": cfg.n_layers}
    if cfg.mla is not None:
        m, mo = cfg.mla, cfg.moe
        want.update(kv_lora_rank=m.kv_lora_rank, q_lora_rank=m.q_lora_rank,
                    qk_rope_head_dim=m.rope_head_dim,
                    qk_nope_head_dim=m.nope_head_dim,
                    v_head_dim=m.v_head_dim, n_routed_experts=mo.num_experts,
                    num_experts_per_tok=mo.top_k,
                    n_shared_experts=mo.num_shared,
                    moe_intermediate_size=mo.d_expert,
                    intermediate_size=cfg.dense_d_ff,
                    first_k_dense_replace=cfg.ffns.index("moe"))
    else:
        want.update(num_key_value_heads=cfg.n_kv_heads,
                    intermediate_size=cfg.d_ff, head_dim=cfg.head_dim,
                    tie_word_embeddings=cfg.tie_embeddings)
    want["rope_theta"] = cfg.attn.rope_theta
    bad = {k: (config[k], v) for k, v in want.items() if config[k] != v}
    if bad:
        raise ValueError(f"the port's {cfg.name} departs from the "
                         f"configuration file (file, port): {bad}")


def _map(tree, fn, path=()):
    """The tree with each tensor leaf replaced by ``fn(path, leaf)``, in
    the tree's order."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]


def make_params(cfg, seed: int, dtype: torch.dtype, device) -> dict:
    """Weights in the port's parameter layout, made on ``device`` from
    ``seed``: one normal draw per dtype (the port keeps the MoE router
    in f32) into one buffer, each leaf a view of it scaled in place
    (dense and expert weights N(0, 1/d_in), embeddings N(0, 0.02^2)),
    norms one, other 1-D leaves zero."""
    from repro_torch.models import transformer as tfm
    meta = tfm.init_params(cfg, generator=None, device="meta", dtype=dtype)
    sizes: dict = {}

    def count(path, t):
        sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel()
    _map(meta, count)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bufs = {}
    for dt in sorted(sizes, key=str):
        bufs[dt] = torch.empty(sizes[dt], dtype=dt, device=device)
        bufs[dt].normal_(generator=gen)
    offs = dict.fromkeys(bufs, 0)

    def view(path, t):
        o = offs[t.dtype]
        v = bufs[t.dtype][o:o + t.numel()].view(t.shape)
        offs[t.dtype] = o + t.numel()
        key = next((p for p in reversed(path) if isinstance(p, str)), "")
        if key in ONES:
            v.fill_(1.0)
        elif key in EMBEDS:
            v.mul_(0.02)
        elif t.dim() == 1:
            v.zero_()
        else:
            v.mul_(1.0 / math.sqrt(t.shape[-2]))
        return v
    return _map(meta, view)


def build_engine(cfg, params, workload: dict, pool_dtype, device):
    """The engine with the workload's options, its pool sized as a
    deployment sizes it: ``max_batch`` sequences of ``max_seq_len``."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Engine
    e = dict(workload["engine"])
    blocks = e["max_batch"] * -(-e["max_seq_len"] // BLOCK)
    return Engine(cfg, params, config=EngineConfig(
        num_blocks=blocks, dtype=pool_dtype, device=device, **e))
