"""The port's training on a device mesh for the Jamba smoke config
(Mamba and attention mixers, dense and MoE FFNs) against the reference's
step, on four gloo CPU ranks: ``tests/test_torch_train_mesh.py``'s
gates, on (data 2, model 2) and (data 4, model 1), and one step on
(data 1, model 4), where each rank computes one of the four experts.
The Mamba mixers run tensor-parallel (a rank computes ``d_inner /
|model|`` channels), attention too (on (1, 4) one of the 4 query heads
a rank, with the KV head ``i // 2`` it reads: 2 KV heads do not split
over 4), the dense FFNs tensor-parallel and the MoE layers
expert-parallel.  Also what a rank holds and computes of a Mamba and an
attention layer, and the gradients of the leaves every ``model`` rank
uses in part.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _train_mesh_cases import (  # noqa: E402
    CONFIGS, MESHES, assert_leaves_close, assert_step_close, jcfg,
    reference_steps, run_ranks, step_cases, value)

NAME = "jamba-v0.1-52b"
#: a Mamba and the attention layer of the smoke config's period
LAYERS = {"mamba": 2, "attn": 4}
#: the leaves every ``model`` rank gets whole and uses in part: Mamba's
#: cut after "copy to model", attention's ``wk`` (KV replicated on (1, 4))
SHARED = {"mamba": ("in_proj", "x_proj", "conv_w", "conv_b", "A_log", "D"),
          "attn": ("wk", "wv")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_mesh_hybrid")
    cases = step_cases(NAME, CONFIGS[NAME], seed=30)
    two = cases[f"{NAME}-g1-steps-2x2"]
    cases[f"{NAME}-g1-steps-1x4"] = dict(two, batches=two["batches"][:1],
                                         mesh=(1, 4))
    cases["layout-1x4"] = dict(kind="layout", cfg=CONFIGS[NAME],
                               params=two["params"], layer=1, mesh=(1, 4))
    for mix, layer in LAYERS.items():
        for mesh in ((2, 2), (1, 4)):
            cases[f"layout-{mix}-{mesh[0]}x{mesh[1]}"] = dict(
                kind="layout", cfg=CONFIGS[NAME], params=two["params"],
                layer=layer, mesh=mesh)
    return run_ranks(work, cases, lambda: reference_steps(cases))


def _case(ranks, mesh, run):
    key = f"{NAME}-g1-{run}-{mesh[0]}x{mesh[1]}"
    return value(ranks[0], key), ranks[2][(NAME, 1, run)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_hybrid_mesh_step_matches_reference(ranks, mesh):
    got, want = _case(ranks, mesh, "steps")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    assert_leaves_close(got["mu"], want["mu"])
    assert_step_close(got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_hybrid_mesh_trajectory_matches_reference(ranks, mesh):
    got, want = _case(ranks, mesh, "steps")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_hybrid_mesh_microbatched_step_matches_reference(ranks, mesh):
    got, want = _case(ranks, mesh, "microbatches")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    assert_leaves_close(got["mu"], want["mu"])
    assert_step_close(got, want)


def test_expert_parallel_step_with_one_expert_a_rank(ranks):
    """(data 1, model 4): the MoE layers keep one of Jamba's four experts
    a rank and compute only it; one step against the reference's
    single-device step at the gates above."""
    got = value(ranks[0], f"{NAME}-g1-steps-1x4")
    want = ranks[2][(NAME, 1, "steps")]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    assert_leaves_close(got["mu"], want["mu"])
    assert_step_close(got, want)
    lay = value(ranks[0], "layout-1x4")
    cfg = jcfg(CONFIGS[NAME])
    D, de = cfg.d_model, cfg.moe.d_expert
    assert lay["tp"][1]
    assert lay["compute"]["ffn"]["w_gate"] == [1, D, de]
    assert lay["compute"]["ffn"]["w_down"] == [1, de, D]


@pytest.mark.parametrize("mix", list(LAYERS))
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_mixer_computes_its_channels_or_heads(ranks, mix, mesh):
    """A Mamba layer computes ``d_inner / |model|`` channels (its output
    whole, its state the rank's channels) from its ``dt_proj`` columns
    and ``out_proj`` rows, gathered over data only, with ``in_proj``
    whole (cut inside the mixer); attention its ``H / |model|`` query
    heads from its ``wq`` columns and ``wo`` rows, and the KV heads they
    read: its ``wk`` and ``wv`` blocks where 2 KV heads split (2, 2),
    else whole, one KV head computed (1, 4)."""
    got = value(ranks[0], f"layout-{mix}-{mesh[0]}x{mesh[1]}")
    cfg = jcfg(CONFIGS[NAME])
    D, n = cfg.d_model, mesh[1]
    used, computed = got["compute"]["mix"], got["mixer"]
    assert got["tp"][0]
    if mix == "mamba":
        DI, N = cfg.d_inner, cfg.mamba.d_state
        R = max(16, D // 16)
        assert got["held"]["mix"]["in_proj"] == [D // mesh[0], 2 * DI // n]
        assert used["in_proj"] == [D, 2 * DI]
        assert used["dt_proj"] == [R, DI // n]
        assert used["out_proj"] == [DI // n, D]
        assert used["x_proj"] == [DI, R + 2 * N]
        assert computed == {"y": [1, 4, D], "state": [1, DI // n, N]}
    else:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kv_cols = KV * hd // n if KV % n == 0 else KV * hd
        assert used["wq"] == [D, H * hd // n]
        assert used["wk"] == used["wv"] == [D, kv_cols]
        assert used["wo"] == [H * hd // n, D]
        assert computed["q"] == [1, 4, H // n, hd]
        assert computed["k"] == computed["v"] == [
            1, 4, max(KV // n, 1), hd]


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_shared_leaf_gradients_match_reference(ranks, mesh):
    """The gradients (first moments) of the leaves every ``model`` rank
    uses in part (:data:`SHARED`), summed over ``model`` once: within
    1e-5 of each leaf's max in every layer of both mixers."""
    got = value(ranks[0], f"{NAME}-g1-steps-{mesh[0]}x{mesh[1]}")
    want = ranks[2][(NAME, 1, "steps")]
    cfg = jcfg(CONFIGS[NAME])
    for j, (bg, bw) in enumerate(zip(got["mu"]["body"],
                                     want["mu"]["body"])):
        for leaf in SHARED[cfg.mixers[j]]:
            assert_leaves_close(bg["mix"][leaf], bw["mix"][leaf])
