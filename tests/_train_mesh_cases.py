"""Cases and gates shared by ``tests/test_torch_train_mesh*.py``.

Each module builds its cases (params from the reference's
``init_params``, batches from NumPy seeds), starts the four gloo ranks of
``tests/_torch_train_ranks.py`` once, and computes the reference's
single-device answers (``make_train_step(cfg, tc, None, donate=False)``,
the oracle of the reference's own sharded step) while the ranks run.
"""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import deepseek_moe_16b as jdsm
from repro.configs import deepseek_v2_236b as jdsv2
from repro.configs import jamba_v0_1_52b as jjamba
from repro.configs import qwen2_5_14b as jqwen
from repro.configs import rwkv6_7b as jrwkv
from repro.configs import whisper_small as jwhisper
from repro.models import transformer as jtfm
from repro.models.config import AttnConfig as JAttn
from repro.models.config import ModelConfig as JCfg
from repro.training import grad_compression as jgc
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from _torch_dist_ranks import spawn

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS = os.path.join(HERE, "_torch_train_ranks.py")
WORLD = 4
MESHES = ((2, 2), (4, 1))
#: a tiny attention-only decoder with tied embeddings (as granite-3-8b)
#: and an odd vocabulary (the vocab-parallel loss's short last shard)
TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=61, head_dim=16, tie_embeddings=True)
#: attention whose query heads read their KV heads in groups a rank's
#: heads do not align with (G 4: 6 heads a rank on 2, 3 on 4)
GQA_ODD = dict(name="gqa-odd", n_layers=1, d_model=32, n_heads=12,
               n_kv_heads=3, d_ff=64, vocab=61, head_dim=8)
#: attention whose query heads do not split evenly over 4 ranks: blocks
#: of 3, 3, 3 and 1 heads (G 5: the second rank reads KV heads 0, 0 and
#: 1, repeated to one a query head), with QKV biases
GQA_UNEVEN = dict(name="gqa-uneven", n_layers=2, d_model=32, n_heads=10,
                  n_kv_heads=2, d_ff=64, vocab=61, head_dim=8,
                  attn=dict(qkv_bias=True))
#: multi-head attention of 3 heads: on 4 ranks the last computes none
MHA_EMPTY = dict(name="mha-empty", n_layers=2, d_model=24, n_heads=3,
                 n_kv_heads=3, d_ff=48, vocab=61, head_dim=8)
#: whisper's smoke config with 3 heads (encoder, decoder and cross
#: attention): on 4 ranks the last computes none in any of them
ENCDEC3 = dict(name="encdec3", n_layers=2, d_model=48, n_heads=3,
               n_kv_heads=3, d_ff=96, vocab=61, head_dim=16, enc_dec=True,
               enc_layers=2, enc_len=24, frontend="audio",
               attn=dict(rope=False))
#: config spec (a dict of fields, ``attn`` a dict of ``AttnConfig``'s; or a
#: smoke config's arch id) → the reference's config
CONFIGS = {"tiny": TINY, "deepseek-moe-16b": "deepseek-moe-16b",
           "jamba-v0.1-52b": "jamba-v0.1-52b", "rwkv6-7b": "rwkv6-7b",
           "deepseek-v2-236b": "deepseek-v2-236b",
           "qwen2.5-14b": "qwen2.5-14b", "gqa-odd": GQA_ODD,
           "gqa-uneven": GQA_UNEVEN, "mha-empty": MHA_EMPTY,
           "whisper-small": "whisper-small", "encdec3": ENCDEC3}
SMOKE = {"deepseek-moe-16b": jdsm, "jamba-v0.1-52b": jjamba,
         "rwkv6-7b": jrwkv, "deepseek-v2-236b": jdsv2, "qwen2.5-14b": jqwen,
         "whisper-small": jwhisper}
LR = 1e-3
B, S, STEPS = 8, 16, 3


def jcfg(spec):
    if isinstance(spec, dict):
        spec = dict(spec)
        if isinstance(spec.get("attn"), dict):
            spec["attn"] = JAttn(**spec["attn"])
        return JCfg(**spec)
    return SMOKE[spec].smoke()


def batches(vocab: int, seed: int, n: int = STEPS, frames=None) -> list:
    """n global batches of (B, S); the labels are the next tokens with
    the last of every row and an uneven share of the first rows masked,
    so the data ranks count unequal labels.  ``frames`` (enc_len, D):
    an encoder-decoder model's frames too, (B, enc_len, D) a batch."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, vocab, (B, S)).astype(np.int32)
        labels = np.roll(toks, -1, 1)
        labels[:, -1] = -100
        labels[0, :5] = -100
        labels[3, :2] = -100
        out.append({"tokens": toks, "labels": labels.astype(np.int32)})
        if frames is not None:
            out[-1]["frames"] = rng.randn(B, *frames).astype(np.float32)
    return out


def train_config(**kw) -> dict:
    return dict(adamw=dict(lr=LR, warmup_steps=1), **kw)


def step_cases(name: str, spec, seed: int, *, groups=(1,),
               compress: bool = False, meshes=MESHES) -> dict:
    """For each of ``meshes``: ``STEPS`` plain steps, one step of 2
    microbatches (and with ``compress`` one compressed step) of every
    routing group count in ``groups``."""
    cfg = jcfg(spec)
    params = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    data = batches(cfg.vocab, seed, frames=(cfg.enc_len, cfg.d_model)
                   if cfg.enc_dec else None)
    cases = {}
    for g in groups:
        runs = {"steps": (dict(moe_groups=g), data),
                "microbatches": (dict(moe_groups=g, microbatches=2),
                                 data[:1])}
        if compress:
            runs["compressed"] = (dict(moe_groups=g, compress_grads=True),
                                  data[:1])
        for run, (tc, bs) in runs.items():
            for mesh in meshes:
                key = f"{name}-g{g}-{run}-{mesh[0]}x{mesh[1]}"
                cases[key] = dict(kind="step", cfg=spec, params=params,
                                  batches=bs, tc=train_config(**tc),
                                  mesh=mesh, ref=(name, g, run))
    return cases


def reference_steps(cases: dict) -> dict:
    """(config, groups, run) → the reference's single-device metrics of
    every step, and its params, first moments and error state after the
    first, from the same params and batches."""
    out = {}
    for c in cases.values():
        if c["kind"] != "step" or c["ref"] in out:
            continue
        tc = dict(c["tc"])
        tc = jtl.TrainConfig(adamw=jopt.AdamWConfig(**tc.pop("adamw")),
                             **tc)
        step = jtl.make_train_step(jcfg(c["cfg"]), tc, None, donate=False)
        p = jax.tree.map(jnp.asarray, c["params"])
        opt = jopt.init_opt_state(p)
        err = (jgc.init_error_state(p) if tc.compress_grads
               else jnp.zeros(()))
        res = {"loss": [], "grad_norm": []}
        for i, b in enumerate(c["batches"]):
            p, opt, err, m = step(p, opt, err,
                                  {k: jnp.asarray(v) for k, v in b.items()})
            res["loss"].append(float(m["loss"]))
            res["grad_norm"].append(float(m["grad_norm"]))
            if i == 0:
                res["params"] = jax.tree.map(np.asarray, p)
                res["mu"] = jax.tree.map(np.asarray, opt["mu"])
                if tc.compress_grads:
                    res["err"] = jax.tree.map(np.asarray, err)
        out[c["ref"]] = res
    return out


def run_ranks(work, cases: dict, reference, script: str = RANKS) -> tuple:
    """Pickle ``cases``, start the ranks of ``script``, compute
    ``reference()`` while they run; returns (rank 0's results, every
    rank's, the reference's answers)."""
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(cases, f)
    ref = {}
    logs = spawn(work, WORLD, script=script, timeout=300,
                 then=lambda: ref.update(reference()))
    assert [code for code, _ in logs] == [0] * WORLD, "\n".join(
        f"rank {r} exited {code}:\n{log[-4000:]}"
        for r, (code, log) in enumerate(logs))
    results = []
    for r in range(WORLD):
        with open(os.path.join(work, f"result_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results[0], results, ref


def value(results: dict, name: str):
    res = results[name]
    assert res["ok"], f"{name}:\n{res['error']}"
    return res["value"]


def _pairs(got, want):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw]
    return [(jax.tree_util.keystr(p), np.asarray(g), np.asarray(w))
            for (p, g), (_, w) in zip(fg, fw)]


def assert_leaves_close(got, want, rel=1e-5):
    """Every leaf within ``rel`` of the leaf's max |want| (``rel`` may be
    a function of the leaf's path)."""
    for name, g, w in _pairs(got, want):
        r = rel(name) if callable(rel) else rel
        bound = r * max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= bound, f"{name}: {err} > {bound}"


def assert_step_close(got: dict, want: dict, rel: float = 1e-5):
    """One step's new params against the reference's: within ``rel`` of
    each leaf's max (of 1 for a leaf below 1: the port's single-device
    step gate, 1e-5 absolute at lr 1e-3) wherever the clipped gradient
    (mu / (1 − b1)) is above 1e-6, elsewhere within 2·lr.  Adam's first
    update is lr·g/(|g| + 1e-8), so a gradient entry near eps moves its
    param by lr times its relative error (anywhere in ±lr), and the f32
    noise of summing the ranks' shares in another order is that large
    there; a leaf that starts at 0 (a bias) is lr·g/(|g| + eps) alone.
    The first moments (:func:`assert_leaves_close`) hold the gradient
    itself to 1e-5 of each leaf's max."""
    for (name, g, w), (_, _, mu) in zip(_pairs(got["params"],
                                               want["params"]),
                                        _pairs(want["mu"], want["mu"])):
        big = np.abs(mu) / 0.1 > 1e-6
        bound = rel * max(np.abs(w).max(), 1.0)
        err = np.abs(g - w)
        assert err[big].max(initial=0) <= bound, (
            f"{name}: {err[big].max()} > {bound}")
        assert err.max() <= 2.02 * LR, name


def assert_int8_close(got, want, bound: dict):
    """Leaf by leaf within 1e-5 of the leaf's max, or within ``bound``
    (one int8 quantum's effect) with 1% to spare where f32 noise in the
    gradient picked the neighbouring int8 level."""
    for (name, g, w), b in zip(_pairs(got, want), jax.tree.leaves(bound)):
        err = np.abs(g - w)
        off = err > 1e-5 * max(np.abs(w).max(), 1e-30)
        assert np.all(err[off] <= 1.01 * b), (name, err.max(), b)
