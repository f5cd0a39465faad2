"""A cell of ``BENCHMARK.json`` cut to its configuration's CPU smoke
size (the port's ``get_smoke``), with traffic and an engine to match:
what the CPU tests drive a whole run with."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import model, spec  # noqa: E402

TRAFFIC = {"clients": 4, "sizes": 64,
           "prompt": {"median": 60, "sigma": 0.6, "min": 20, "max": 200},
           "output": {"median": 6, "sigma": 0.3, "min": 4, "max": 12}}


def smoke_numbers(cfg) -> dict:
    """The configuration file's keys at the smoke config's sizes."""
    out = {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
           "num_hidden_layers": cfg.n_layers, "vocab_size": cfg.vocab,
           "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.attn.rope_theta}
    if cfg.mla is not None:
        m, mo = cfg.mla, cfg.moe
        out.update(kv_lora_rank=m.kv_lora_rank, q_lora_rank=m.q_lora_rank,
                   qk_rope_head_dim=m.rope_head_dim,
                   qk_nope_head_dim=m.nope_head_dim, v_head_dim=m.v_head_dim,
                   n_routed_experts=mo.num_experts,
                   num_experts_per_tok=mo.top_k,
                   n_shared_experts=mo.num_shared,
                   moe_intermediate_size=mo.d_expert,
                   intermediate_size=cfg.dense_d_ff,
                   first_k_dense_replace=cfg.ffns.index("moe"))
    else:
        out.update(num_key_value_heads=cfg.n_kv_heads,
                   intermediate_size=cfg.d_ff, head_dim=cfg.head_dim,
                   tie_word_embeddings=cfg.tie_embeddings)
    return out


def smoke_cell(name: str, limit: float = 1.0, root: Path = ROOT,
               dtype: str | None = None):
    """(cell, port config) of ``name`` at the smoke size; ``limit`` is
    the smoke cell's logit-gap limit, ``dtype`` (weights and pool) the
    configuration's unless given."""
    cell = spec.load(name, root)
    cfg = model.port_config(cell.config, smoke=True)
    config = {**cell.config, **smoke_numbers(cfg)}
    if dtype is not None:
        config["port"] = {**config["port"], "dtype": dtype,
                          "pool_dtype": dtype}
    model.check_config(config, cfg)
    engine = {**cell.workload["engine"], "max_batch": 4, "max_seq_len": 256}
    workload = {"engine": engine,
                "check": {"served_tokens": 60,
                          "limits": {k: limit for k in
                                     cell.workload["check"]["limits"]}}}
    return dataclasses.replace(cell, config=config, traffic=dict(TRAFFIC),
                               workload=workload), cfg


def run_module():
    """``perfbench/run.py`` as a module."""
    import importlib.util
    spec_ = importlib.util.spec_from_file_location(
        "perfbench_run", ROOT / "perfbench" / "run.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod
