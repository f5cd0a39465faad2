"""The port's serving from sharded weights against the JAX reference, on
four gloo CPU ranks.

The reference serves on a mesh by jitting ``prefill`` and
``decode_step`` under ``param_specs`` and the batch rows of every input
over ``decode_axes``' batch axes; GSPMD changes placement, never math, so
the oracle is its single-device ``prefill`` + ``decode_step(page_impl=
"ref")``.  Each rank of ``tests/_torch_serve_ranks.py`` holds only its
``param_specs`` blocks (``sharding.shard_params``), serves its batch rows
through a ``distributed.parallel.Layout`` and gathers the logits:

* smoke configs of granite (the tiny tied decoder, odd vocabulary),
  qwen2.5 (QKV biases), DeepSeek-V2 (MLA + MoE), Jamba (Mamba, attention
  and MoE), RWKV-6, whisper (frames) and InternVL2 (patches), plus
  attention whose KV heads do not split over ``model`` (``GQA_ODD``);
* on (data 2, model 2), (4, 1) and, where the heads split over 4, (1, 4);
  ``page_impl="sp"``, and ``"sp_opt"`` for tiny and DeepSeek-V2;
* gates: greedy tokens equal and logits within 1e-5 (the gates of
  ``test_decode_step_on_a_mesh_matches_reference``), every rank the same
  logits; each rank holds exactly its ``param_specs`` blocks, computes
  ``1/|model|`` of the split mixers' heads or channels and the dense
  FFN's columns, holds its batch rows and the recurrent states' shares;
  one decode step's all-gathers are exactly the layers' blocks over
  ``data`` (and whole ``wk``/``wv`` where KV does not split) and the
  activations over ``model``; and a (2, 2) checkpoint of
  ``make_train_step`` restored onto the mesh serves the tokens of the
  same checkpoint served whole, with no collective to restore it.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JCfg  # noqa: E402
from _train_mesh_cases import GQA_ODD, TINY, batches, run_ranks  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS = os.path.join(HERE, "_torch_serve_ranks.py")
B, S, NEW, MAX_LEN = 4, 140, 6, 512
#: config name → (spec: fields or a smoke config's arch id, seed)
CONFIGS = {"tiny": (TINY, 1), "qwen2.5": ("qwen2.5-14b", 2),
           "deepseek-v2": ("deepseek-v2-236b", 3),
           "jamba": ("jamba-v0.1-52b", 4), "rwkv6": ("rwkv6-7b", 5),
           "whisper": ("whisper-small", 6), "internvl2": ("internvl2-26b", 7),
           "gqa-odd": (GQA_ODD, 8)}
SP_OPT = ("tiny", "deepseek-v2")


def jcfg(spec) -> JCfg:
    return JCfg(**spec) if isinstance(spec, dict) else get_smoke(spec)


def meshes(name: str) -> list:
    """(2, 2) and (4, 1), and (1, 4) where the heads split over 4."""
    cfg = jcfg(CONFIGS[name][0])
    heads = cfg.d_model // 64 if "rwkv6" in cfg.mixers else cfg.n_heads
    if name == "gqa-odd":
        return [(2, 2)]
    return [(2, 2), (4, 1)] + ([(1, 4)] if heads % 4 == 0 else [])


CASES = [(name, mesh, impl) for name in CONFIGS for mesh in meshes(name)
         for impl in ("sp",) + (("sp_opt",) if name in SP_OPT else ())]
IDS = [f"{n}-{d}x{m}-{i}" for n, (d, m), i in CASES]


def inputs(name: str) -> dict:
    spec, seed = CONFIGS[name]
    cfg = jcfg(spec)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    extras = {}
    if cfg.enc_dec:
        extras["enc_frames"] = rng.randn(B, cfg.enc_len,
                                         cfg.d_model).astype(np.float32)
    if cfg.frontend == "vision":
        extras["patches"] = rng.randn(B, cfg.prefix_tokens,
                                      cfg.d_model).astype(np.float32)
    return dict(cfg=spec, params=params, extras=extras,
                prompt=rng.randint(1, cfg.vocab, (B, S)).astype(np.int32))


_jprefill = jax.jit(jtfm.prefill, static_argnums=1)
_jdecode = jax.jit(jtfm.decode_step, static_argnums=1)


def reference(inp: dict) -> np.ndarray:
    """Prefill + NEW greedy ``decode_step(page_impl="ref")`` logits of
    the reference on one device."""
    cfg = jcfg(inp["cfg"])
    params = jax.tree.map(jnp.asarray, inp["params"])
    st = jtfm.init_decode_state(cfg, B, MAX_LEN, dtype=jnp.float32)
    logits, st = _jprefill(params, cfg, jnp.asarray(inp["prompt"]), st,
                           **{k: jnp.asarray(v)
                              for k, v in inp["extras"].items()})
    out = [np.asarray(logits)]
    for _ in range(NEW):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, st = _jdecode(params, cfg, st, tok)
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_mesh")
    inp = {name: inputs(name) for name in CONFIGS}
    cases = {f"{n}-{d}x{m}-{i}": dict(kind="serve", mesh=(d, m), impl=i,
                                      new=NEW, max_len=MAX_LEN, **inp[n])
             for n, (d, m), i in CASES}
    tiny = inp["tiny"]
    cases["restore"] = dict(kind="restore", mesh=(2, 2), cfg=TINY,
                            params=tiny["params"], prompt=tiny["prompt"],
                            batch=batches(TINY["vocab"], 9, 1)[0], new=NEW,
                            max_len=MAX_LEN)
    first, every, ref = run_ranks(
        work, cases, lambda: {n: reference(inp[n]) for n in CONFIGS},
        script=RANKS)
    return first, every, ref


def value(results: dict, name: str):
    res = results[name]
    assert res["ok"], f"{name}:\n{res['error']}"
    return res["value"]


@pytest.mark.parametrize("name,mesh,impl", CASES, ids=IDS)
def test_serving_from_blocks_matches_reference(ranks, name, mesh, impl):
    """Greedy tokens equal, logits within 1e-5 of the reference's
    single-device decode, and every rank gathers the same logits."""
    first, every, ref = ranks
    case = f"{name}-{mesh[0]}x{mesh[1]}-{impl}"
    got = value(first, case)["logits"]
    want = ref[name]
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for r, res in enumerate(every):
        assert np.array_equal(value(res, case)["logits"], got), r


def _expected_compute(cfg, mix: str, ffn: str, n: int, step: str) -> dict:
    """Compute shapes of a layer whose split parts take 1/n: the leaves
    that show the split, and the mixer's heads."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    want: dict = {"mix": {}, "ffn": {}}
    mixer: dict = {}
    if mix == "attn" and H % n == 0:
        kv = KV // n if KV % n == 0 else KV
        want["mix"] = {"wq": [D, H // n * hd], "wk": [D, kv * hd],
                       "wo": [H // n * hd, D]}
        if n > 1:                       # serving_qkv: the rank's heads
            mixer = {"q": [1, 2, H // n, hd], "kv": [1, 2, 2 * KV, hd]}
    elif mix == "mla" and H % n == 0:
        m = cfg.mla
        qk = m.nope_head_dim + m.rope_head_dim
        want["mix"] = {"wq_a": [D, m.q_lora_rank],
                       "wq_b": [m.q_lora_rank, H // n * qk],
                       "wkv_b": [m.kv_lora_rank,
                                 H // n * (m.nope_head_dim + m.v_head_dim)],
                       "wo": [H // n * m.v_head_dim, D]}
        mixer = {"q": [1, 2, H // n, m.nope_head_dim]}
    elif mix == "mamba" and cfg.d_inner % n == 0:
        DI = cfg.d_inner
        want["mix"] = {"in_proj": [D, 2 * DI // (n if step == "decode"
                                                 else 1)],
                       "out_proj": [DI // n, D]}
    elif mix == "rwkv6" and (D // 64) % n == 0:
        want["mix"] = {"wr": [D, D // n], "wo": [D // n, D]}
    if ffn == "dense":
        F = cfg.dense_d_ff or cfg.d_ff
        want["ffn"] = {"w_gate": [D, F // n], "w_down": [F // n, D]}
    else:
        mo = cfg.moe
        de = mo.d_expert or cfg.d_ff
        want["ffn"] = {"w_gate": [mo.num_experts // n, D, de],
                       "router": [D, mo.num_experts]}
    return want, mixer


@pytest.mark.parametrize("name,mesh,impl", CASES, ids=IDS)
def test_rank_holds_its_blocks_rows_and_shares(ranks, name, mesh, impl):
    """Every rank's params are exactly its ``param_specs`` blocks; it
    serves ``B / |data|`` rows (where the batch splits), its state holds
    those rows, Mamba's ``d_inner/|model|`` channels and RWKV-6's
    ``nH/|model|`` heads; each split mixer and the dense FFN compute with
    ``1/|model|`` of their heads, channels or columns (Mamba's decode
    keeps ``in_proj``'s block, its prefill gathers it whole)."""
    first, every, _ = ranks
    cfg = jcfg(CONFIGS[name][0])
    d, n = mesh
    case = f"{name}-{d}x{n}-{impl}"
    for r, res in enumerate(every):
        assert value(res, case)["held_differ"] == [], r
    got = value(first, case)
    Bl = B // d if d > 1 else B
    assert got["batch_axes"] == (["data"] if d > 1 else [])
    assert got["logits_rows"] == [Bl, cfg.vocab]
    st = got["state"]
    L, D = cfg.n_layers, cfg.d_model
    assert st["lengths"] == [Bl] and st["tables"][0] == Bl
    if "mamba" in cfg.mixers:
        DI, n_m = cfg.d_inner, cfg.mixers.count("mamba")
        assert st["conv"] == [n_m, Bl, cfg.mamba.d_conv - 1, DI // n]
        assert st["ssm"] == [n_m, Bl, DI // n, cfg.mamba.d_state]
    if "rwkv6" in cfg.mixers:
        nH = D // 64
        split = n if nH % n == 0 else 1
        assert st["rwkv_x"] == [L, Bl, D]
        assert st["rwkv_s"] == [L, Bl, nH // split, 64, 64]
    if cfg.enc_dec:
        assert st["cross_k"] == [L, Bl, cfg.enc_len, cfg.n_kv_heads,
                                 cfg.head_dim]
    for step in ("prefill", "decode"):
        for i, layer in enumerate(got["compute"][step]):
            mix, ffn = cfg.mixers[i], cfg.ffns[i]
            want, mixer = _expected_compute(cfg, mix, ffn, n, step)
            for part, leaves in want.items():
                for leaf, shape in leaves.items():
                    assert layer["params"][part][leaf] == shape, (
                        step, i, part, leaf)
            for k, shape in mixer.items():
                assert layer["mixer"][k] == shape, (step, i, k)
            assert layer["tp"] == [n > 1 and bool(want["mix"]),
                                   n > 1], (step, i)


def _layer_bytes(cfg, leaves, n: int, kept: bool) -> int:
    """f32 bytes of the named leaves of one layer, each its model block
    (``kept``) or whole."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F = cfg.d_ff
    size = {"wq": D * H * hd, "wk": D * KV * hd, "wv": D * KV * hd,
            "wo": H * hd * D, "w_gate": D * F, "w_up": D * F,
            "w_down": F * D}
    return sum(4 * size[k] // (n if kept else 1) for k in leaves)


@pytest.mark.parametrize("name", ["tiny", "gqa-odd", "whisper"])
def test_decode_step_gathers_only_its_blocks(ranks, name):
    """One decode step on (data 2, model 2), rank 0 (its data group
    ranks (0, 2), model group (0, 1)): the all-gathers over ``data`` are
    exactly each layer's model blocks of the attention and FFN leaves and,
    untied (``GQA_ODD``), the unembedding's vocabulary rows (31 of 61);
    where KV does not split over ``model`` (``GQA_ODD``: 3 KV heads)
    ``wk`` and ``wv`` come whole over all four ranks instead; whisper's
    cross-attention ``wq`` and ``wo`` are its 4 heads' blocks over
    ``data``, as its self attention's (its encoder, frontend and cross
    ``wk``/``wv`` are prefill's alone: never gathered in decode); over
    ``model`` move only the activations: the rank's query
    heads, its KV heads' fused K/V where KV splits, and the logits'
    vocabulary columns (61 padded to 2 x 31)."""
    first, _, _ = ranks
    cfg = jcfg(CONFIGS[name][0])
    traffic = value(first, f"{name}-2x2-sp")["traffic"]
    gathers = {r: v for (k, r), v in traffic.items() if k == "all-gather"}
    L, n, Bl = cfg.n_layers, 2, B // 2
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_split = KV % n == 0
    blocks = ("wq", "wo") + (("wk", "wv") if kv_split else ())
    ffn = ("w_gate", "w_up", "w_down")
    want = {(0, 2): [L * (len(blocks) + 3),
                     L * _layer_bytes(cfg, blocks + ffn, n, True)],
            (0, 1): [L * (1 + kv_split) + 1,
                     4 * (L * Bl * (H * hd + kv_split * 2 * KV * hd)
                          + Bl * n * -(-cfg.vocab // n))]}
    if not cfg.tie_embeddings:
        want[(0, 2)][0] += 1
        want[(0, 2)][1] += 4 * -(-cfg.vocab // n) * cfg.d_model
    if not kv_split:
        want[(0, 1, 2, 3)] = [2 * L, L * _layer_bytes(cfg, ("wk", "wv"), n,
                                                      False)]
    if cfg.enc_dec:                     # the cross attention's blocks
        want[(0, 2)][0] += 2 * L
        want[(0, 2)][1] += L * _layer_bytes(cfg, ("wq", "wo"), n, True)
    assert gathers == want


def test_restored_checkpoint_serves_from_blocks(ranks):
    """A (2, 2) checkpoint of ``make_train_step`` restored onto the mesh
    (``CheckpointManager.restore(mesh=, specs=)``, no collective) holds
    exactly the rank's blocks and serves the tokens of the same
    checkpoint served whole on one process, logits within 1e-5."""
    _, every, _ = ranks
    for r, res in enumerate(every):
        got = value(res, "restore")
        assert got["restore_calls"] == 0, r
        assert got["held_differ"] == [], r
        np.testing.assert_array_equal(got["mesh"].argmax(-1),
                                      got["whole"].argmax(-1))
        np.testing.assert_allclose(got["mesh"], got["whole"], rtol=1e-5,
                                   atol=1e-5)
