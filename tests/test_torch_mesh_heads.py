"""Attention whose query heads do not split evenly over ``model``, and
whisper's encoder and cross attention on a mesh, against the reference.

The reference splits the columns of ``wq``, ``wk`` and ``wv`` (and
``wo``'s rows) over ``model`` whatever the head count, in the decoder,
the whisper encoder and the cross attention, and GSPMD runs that split;
its single-device step and decode are the oracle of every mesh step.  A
rank of the port computes the contiguous query heads ``[i·Hc, min((i+1)
·Hc, H))``, ``Hc = ⌈H/|model|⌉`` (``parallel.block``): the last blocks
short, some empty.

(a) ``rank_heads`` and ``TensorParallel.cut`` over a grid of (H, KV, n),
    no ranks;
(b) on (data 1, model 4): ``GQA_UNEVEN`` (10 heads, 2 KV heads, QKV
    biases: blocks of 3, 3, 3, 1, one rank reading two KV heads
    unevenly) and ``MHA_EMPTY`` (3 heads: the last rank computes none);
(c) whisper's smoke config on (2, 2): its encoder and cross attention
    from the rank's blocks;
(d) ``ENCDEC3``, a 3-head encoder-decoder, on (1, 4): a rank with no
    heads in the encoder, the decoder and the cross attention.

Each is trained (``tests/test_torch_train_mesh.py``'s gates: a step,
3-step trajectory, two microbatches) and served from the rank's
``param_specs`` blocks (``tests/test_torch_serve_mesh.py``'s gates:
greedy tokens, logits within 1e-5, every rank the same) on four gloo
CPU ranks of ``tests/_torch_train_ranks.py``, started once for the
module while the reference jits its single-device steps and decode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.parallel import TensorParallel, block  # noqa: E402
from repro_torch.models.attention import rank_heads  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from _train_mesh_cases import (  # noqa: E402
    CONFIGS, assert_leaves_close, assert_step_close, jcfg, reference_steps,
    run_ranks, step_cases, value)

#: config → (mesh, seed)
RUNS = {"gqa-uneven": ((1, 4), 60), "mha-empty": ((1, 4), 61),
        "whisper-small": ((2, 2), 62), "encdec3": ((1, 4), 63)}
IDS = [f"{n}-{m[0]}x{m[1]}" for n, (m, _) in RUNS.items()]
#: serving: B prompts of S tokens, NEW greedy decode steps
B, S, NEW, MAX_LEN = 4, 140, 6, 512


# ------------------------------------------------------------------ (a)
class _Rank(TensorParallel):
    """A rank's tensor-parallel map without a process group: ``cut``'s
    ``copy_in`` is the identity forward."""

    def __init__(self, size: int, index: int):
        self.mesh, self.axis, self.size, self.index = None, "model", size, index


GRID = [(H, KV, n) for H, KV in ((40, 8), (12, 12), (12, 4), (10, 2),
                                 (10, 5), (3, 3), (3, 1))
        for n in (1, 2, 3, 4, 16)]


@pytest.mark.parametrize("H,KV,n", GRID,
                         ids=[f"H{h}-KV{k}-n{n}" for h, k, n in GRID])
def test_rank_heads_and_cut_split_the_heads(H, KV, n):
    """The ranks' query heads are contiguous blocks in rank order, cover
    every head once, each ⌈H/n⌉ or fewer; each rank's KV range is exactly
    the KV heads its query heads read and ``read`` maps each query head to
    its own; ``cut`` of a (D, H·hd) leaf along its columns (unit hd) and
    of a (H·hd, D) one along its rows take those heads'."""
    hd, G = 4, H // KV
    cfg = ModelConfig(name="grid", n_layers=1, d_model=8, n_heads=H,
                      n_kv_heads=KV, d_ff=8, vocab=8, head_dim=hd)
    w = torch.arange(8 * H * hd, dtype=torch.float32).reshape(8, H * hd)
    nxt = 0
    for i in range(n):
        tp = _Rank(n, i)
        q0, Hl, k0, k1, read = rank_heads(cfg, tp)
        assert (q0, q0 + Hl) == tp.block(H) == block(H, n, i)
        assert q0 == min(nxt, H) and 0 <= Hl <= -(-H // n)
        nxt = q0 + Hl
        heads = range(q0, q0 + Hl)
        kvs = sorted({h // G for h in heads})
        assert list(range(k0, k1)) == kvs
        got = ([k0 + r for r in read] if read is not None
               else [k0 + j // (Hl // (k1 - k0)) for j in range(Hl)])
        assert got == [h // G for h in heads]
        cols = tp.cut(w, 1, hd)
        assert torch.equal(cols, w[:, q0 * hd:(q0 + Hl) * hd])
        assert torch.equal(tp.cut(w.T, 0, hd), cols.T)
    assert nxt == H


def test_production_head_blocks():
    """qwen2.5-14b on 16 ranks: 3 heads on 13, 1 on one, 0 on two;
    whisper-small on 16: 1 head on 12, 0 on four; qwen2.5-14b on 3: 14,
    14, 12 heads reading KV heads 0-2, 2-5, 5-7."""
    def split(arch, n):
        return [rank_heads(get_config(arch), _Rank(n, i)) for i in range(n)]
    assert [r[1] for r in split("qwen2.5-14b", 16)] == [3] * 13 + [1, 0, 0]
    assert [r[1] for r in split("whisper-small", 16)] == [1] * 12 + [0] * 4
    assert [(r[1], r[2], r[3]) for r in split("qwen2.5-14b", 3)] == [
        (14, 0, 3), (14, 2, 6), (12, 5, 8)]


# ------------------------------------------------------------- (b)-(d)
def serve_inputs(spec, seed: int) -> dict:
    cfg = jcfg(spec)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    extras = {}
    if cfg.enc_dec:
        extras["enc_frames"] = rng.randn(B, cfg.enc_len,
                                         cfg.d_model).astype(np.float32)
    return dict(cfg=spec, params=params, extras=extras,
                prompt=rng.randint(1, cfg.vocab, (B, S)).astype(np.int32))


_jprefill = jax.jit(jtfm.prefill, static_argnums=1)
_jdecode = jax.jit(jtfm.decode_step, static_argnums=1)


def serve_reference(inp: dict) -> np.ndarray:
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
    work = tmp_path_factory.mktemp("mesh_heads")
    cases, serving = {}, {}
    for name, (mesh, seed) in RUNS.items():
        cases.update(step_cases(name, CONFIGS[name], seed, meshes=(mesh,)))
        c = cases[f"{name}-g1-steps-{mesh[0]}x{mesh[1]}"]
        cases[f"layout-{name}"] = dict(kind="layout", cfg=CONFIGS[name],
                                       params=c["params"], layer=0,
                                       mesh=mesh)
        serving[name] = serve_inputs(CONFIGS[name], seed)
        cases[f"serve-{name}"] = dict(kind="serve", mesh=mesh, impl="sp",
                                      new=NEW, max_len=MAX_LEN,
                                      **serving[name])

    def reference():
        out = {"steps": reference_steps(cases)}
        out["serve"] = {n: serve_reference(inp)
                        for n, inp in serving.items()}
        return out
    return run_ranks(work, cases, reference)


def _case(ranks, name, run):
    mesh = RUNS[name][0]
    key = f"{name}-g1-{run}-{mesh[0]}x{mesh[1]}"
    return value(ranks[0], key), ranks[2]["steps"][(name, 1, run)]


@pytest.mark.parametrize("name", RUNS, ids=IDS)
def test_heads_mesh_step_matches_reference(ranks, name):
    """One step: loss and grad norm within 1e-5 relative, first moments
    (the clipped gradient) within 1e-5 of each leaf's max, params within
    ``assert_step_close``'s gate."""
    got, want = _case(ranks, name, "steps")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    assert_leaves_close(got["mu"], want["mu"])
    assert_step_close(got, want)


@pytest.mark.parametrize("name", RUNS, ids=IDS)
def test_heads_mesh_trajectory_matches_reference(ranks, name):
    got, want = _case(ranks, name, "steps")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)


@pytest.mark.parametrize("name", RUNS, ids=IDS)
def test_heads_mesh_microbatched_step_matches_reference(ranks, name):
    got, want = _case(ranks, name, "microbatches")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    assert_leaves_close(got["mu"], want["mu"])
    assert_step_close(got, want)


def _layers(tree, part: str) -> list:
    """``part`` of every layer in the reference's layout: the prefix
    layers', the body's (each leaf stacked over the blocks), or the
    encoder layers' attention for ``part == "encoder"``."""
    if part == "encoder":
        return [lp["mix"] for lp in tree["encoder"]]
    return [lp[part] for lp in (*tree["prefix"], *tree["body"])]


#: (config, part, leaf): the leaves a rank gets whole and uses in part
#: (the query and output projections of heads that do not split evenly,
#: KV projections and biases), held leaf by leaf in every layer
WHOLE_CUT = ([("gqa-uneven", "mix", k)
              for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")]
             + [("mha-empty", "mix", k) for k in ("wq", "wk", "wv", "wo")]
             + [("encdec3", part, k) for part in ("mix", "cross", "encoder")
                for k in ("wq", "wk", "wv", "wo")])


@pytest.mark.parametrize("name,part,leaf", WHOLE_CUT,
                         ids=[f"{n}-{p}-{k}" for n, p, k in WHOLE_CUT])
def test_whole_cut_leaf_gradients_match_reference(ranks, name, part, leaf):
    """A leaf gathered whole and cut to each rank's heads (blocks of
    unequal size, one empty) gets its gradient summed over ``model``
    exactly once: its first moments within 1e-5 of the leaf's max in
    every layer."""
    got, want = _case(ranks, name, "steps")
    for g, w in zip(_layers(got["mu"], part), _layers(want["mu"], part),
                    strict=True):
        assert_leaves_close(g[leaf], w[leaf])


@pytest.mark.parametrize("name", RUNS, ids=IDS)
def test_heads_serving_matches_reference(ranks, name):
    """Served from the rank's blocks: greedy tokens equal, logits within
    1e-5 of the reference's single-device decode, every rank the same
    logits."""
    first, every, ref = ranks
    got = value(first, f"serve-{name}")["logits"]
    want = ref["serve"][name]
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for r, res in enumerate(every):
        assert np.array_equal(value(res, f"serve-{name}")["logits"], got), r


def _blocks(cfg, n: int) -> list:
    return [min(-(-cfg.n_heads // n), max(cfg.n_heads - i * -(
        -cfg.n_heads // n), 0)) for i in range(n)]


@pytest.mark.parametrize("name", RUNS, ids=IDS)
def test_rank_computes_its_block_of_heads(ranks, name):
    """Every rank computes its block of query heads, 3/3/3/1 (10 heads),
    1/1/1/0 (3 heads) or 2/2 (4 heads on 2): in training's attention
    (``qkv_proj``: q and the KV heads it reads), in serving's prefill and
    decode (``serving_qkv``: the fused K/V of every KV head for the
    cache), and in the encoder's attention.  ``wq`` and ``wo`` come
    whole where the heads do not split evenly, else as the rank's
    block; no rank holds more than its ``param_specs`` blocks."""
    _, every, _ = ranks
    cfg = jcfg(CONFIGS[name])
    (d, n), H, KV, hd, D = (RUNS[name][0], cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.d_model)
    even = H % n == 0
    for r, res in enumerate(every):
        i = r % n                           # the rank's model index
        Hl = _blocks(cfg, n)[i]
        tp = _Rank(n, i)
        _, _, k0, k1, read = rank_heads(cfg, tp)
        kl = Hl if read is not None else k1 - k0
        lay = value(res, f"layout-{name}")
        assert lay["tp"] == [True, True]
        assert lay["mixer"]["q"] == [1, 4, Hl, hd], r
        assert lay["mixer"]["k"] == lay["mixer"]["v"] == [1, 4, kl, hd], r
        wq = [D, H * hd // n] if even else [D, H * hd]
        assert lay["compute"]["mix"]["wq"] == wq, r
        assert lay["compute"]["mix"]["wo"] == wq[::-1], r
        if cfg.enc_dec:
            enc = lay["encoder"]
            assert enc["tp"] == [True, True]
            assert enc["compute"]["mix"]["wq"] == wq, r
            assert enc["held"]["mix"]["wq"] == [-(-D // d),
                                                -(-H * hd // n)], r
            assert enc["mixer"]["q"] == [1, 4, Hl, hd], r
            assert lay["compute"]["cross"]["wq"] == wq, r
            assert lay["compute"]["cross"]["wk"] == [D, KV * hd], r
        serve = value(res, f"serve-{name}")
        assert serve["held_differ"] == [], r
        for step in ("prefill", "decode"):
            for layer in serve["compute"][step]:
                assert layer["mixer"]["q"] == [1, 2, Hl, hd], (r, step)
                assert layer["mixer"]["kv"] == [1, 2, 2 * KV, hd], (r, step)


def test_uneven_decode_gathers_whole_projections(ranks):
    """``GQA_UNEVEN``'s decode step on (1, 4), rank 0: over ``model`` (all
    four ranks; ``data`` has one) it all-gathers each layer's whole
    ``wq``, ``wk``, ``wv`` and ``wo`` (10 heads and 2 KV heads split
    over 4 neither), the query heads for the SP decode (blocks of 3
    padded to 4 × 3) and the logits' vocabulary columns (61 padded to
    4 × 16); nothing else."""
    cfg = jcfg(CONFIGS["gqa-uneven"])
    traffic = value(ranks[0], "serve-gqa-uneven")["traffic"]
    gathers = {r: v for (k, r), v in traffic.items() if k == "all-gather"}
    L, D, H, KV, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    weights = 4 * L * (2 * D * H * hd + 2 * D * KV * hd)
    acts = 4 * (L * B * 4 * 3 * hd + B * 4 * 16)
    assert gathers == {(0, 1, 2, 3): [5 * L + 1, weights + acts]}
