"""The port's training on a device mesh for the Jamba smoke config
(Mamba and attention mixers, dense and MoE FFNs) against the reference's
step, on four gloo CPU ranks: ``tests/test_torch_train_mesh.py``'s
gates, on (data 2, model 2) and (data 4, model 1), and one step on
(data 1, model 4), where each rank computes one of the four experts.
The Mamba mixers run whole on every rank (gathered just in time),
attention and the dense FFNs tensor-parallel (attention whole on
(1, 4): 2 KV heads do not split over 4), the MoE layers expert-parallel.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _train_mesh_cases import (  # noqa: E402
    CONFIGS, MESHES, assert_leaves_close, assert_step_close, jcfg,
    reference_steps, run_ranks, step_cases, value)

NAME = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_mesh_hybrid")
    cases = step_cases(NAME, CONFIGS[NAME], seed=30)
    two = cases[f"{NAME}-g1-steps-2x2"]
    cases[f"{NAME}-g1-steps-1x4"] = dict(two, batches=two["batches"][:1],
                                         mesh=(1, 4))
    cases["layout-1x4"] = dict(kind="layout", cfg=CONFIGS[NAME],
                               params=two["params"], layer=1, mesh=(1, 4))
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
