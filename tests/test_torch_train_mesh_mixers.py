"""The port's training on a device mesh for the RWKV-6, DeepSeek-V2
(MLA) and Qwen2.5 (attention with QKV biases) smoke configs and an
attention whose head groups do not align with the ranks' heads, against
the reference's step, on four gloo CPU ranks:
``tests/test_torch_train_mesh.py``'s gates (step, 3-step trajectory,
two microbatches) on (data 2, model 2), (data 4, model 1) and (data 1,
model 4).  The mixers run tensor-parallel wherever their heads split
over ``model``: on (2, 2) a rank computes one of RWKV-6's two heads and
two of MLA's four, on (1, 4) one MLA head a rank, while RWKV-6's two
heads do not split over 4 and the mixer runs whole on every rank;
Qwen's 2 KV heads split on (2, 2) and are gathered whole on (1, 4),
each rank computing the one its query head reads, its biases cut;
``GQA_ODD``'s ranks compute 6 (3) query heads, whose KV heads (2 on
some ranks, read unevenly) are repeated to one a query head.  Also what a rank holds and
computes of a layer, the bytes a mixer's gathers move, and the
gradients of the leaves every ``model`` rank uses in part.

RWKV-6 rounds its decay, and the decay's cotangent, through bf16 in both
packages, so f32 summation-order differences show at bf16's resolution:
the port's own single-device step misses 1e-5 on this batch (its first
moments up to 1.9e-5 of a leaf's max, the decay LoRA's 3.5e-4, the grad
norm 1.3e-4 off after 3 steps).  Its leaves are held to the port's
single-device RWKV-6 gradient gates instead
(``tests/test_torch_train_grads_hybrid.py``: 3e-5, the decay LoRA
2e-3), and its 3-step grad norms to :data:`RWKV_TRAJ_GN_RTOL`.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _train_mesh_cases import (  # noqa: E402
    CONFIGS, MESHES, assert_leaves_close, assert_step_close, jcfg,
    reference_steps, run_ranks, step_cases, value)
from test_torch_train_grads_hybrid import (  # noqa: E402
    RWKV_LORA_RTOL, RWKV_RTOL)

NAMES = ("rwkv6-7b", "deepseek-v2-236b", "qwen2.5-14b", "gqa-odd")
ALL_MESHES = MESHES + ((1, 4),)
#: (config, mesh): the layer-0 layouts the tests read
LAYOUTS = [(n, m) for n in NAMES for m in ((2, 2), (1, 4))]
#: attention's layouts: (query heads, KV heads) rank 0 computes (GQA_ODD
#: on (2, 2): heads 0-5 read KV heads 0, 0, 0, 0, 1, 1, repeated to 6;
#: on (1, 4): heads 0-2 all read KV head 0)
ATTN_HEADS = {("qwen2.5-14b", (2, 2)): (2, 1), ("qwen2.5-14b", (1, 4)): (1, 1),
              ("gqa-odd", (2, 2)): (6, 6), ("gqa-odd", (1, 4)): (3, 1)}
#: RWKV-6's leaves every ``model`` rank gets whole and uses in part (or
#: computes whole and feeds to its heads)
RWKV_SHARED = ("mu", "w_lora_a", "w_lora_b", "u", "ln_x")
#: RWKV-6's grad norms over 3 steps (the module doc): measured 1.3e-4 off
#: the reference for the port's single-device step and (4, 1), 5.7e-4 for
#: (2, 2)
RWKV_TRAJ_GN_RTOL = 1e-3


def _rtol(name: str):
    """A config's gradient gate (``assert_leaves_close``'s ``rel``): 1e-5,
    RWKV-6's by leaf as its single-device one."""
    if not name.startswith("rwkv6"):
        return 1e-5
    return lambda leaf: (RWKV_LORA_RTOL if "w_lora" in leaf else RWKV_RTOL)


def _mesh_id(m):
    return f"{m[0]}x{m[1]}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_mesh_mixers")
    cases = {}
    for i, name in enumerate(NAMES):
        cases.update(step_cases(name, CONFIGS[name], seed=40 + i,
                                meshes=ALL_MESHES))
    for name, mesh in LAYOUTS:
        c = cases[f"{name}-g1-steps-2x2"]
        cases[f"layout-{name}-{_mesh_id(mesh)}"] = dict(
            kind="layout", cfg=CONFIGS[name], params=c["params"], layer=0,
            mesh=mesh)
    return run_ranks(work, cases, lambda: reference_steps(cases))


def _case(ranks, name, mesh, run):
    key = f"{name}-g1-{run}-{_mesh_id(mesh)}"
    return value(ranks[0], key), ranks[2][(name, 1, run)]


PAIRS = [(n, m) for n in NAMES for m in ALL_MESHES]
IDS = [f"{n}-{_mesh_id(m)}" for n, m in PAIRS]


@pytest.mark.parametrize("name,mesh", PAIRS, ids=IDS)
def test_mixer_mesh_step_matches_reference(ranks, name, mesh):
    """One step: loss and grad norm within 1e-5 relative, first moments
    within the config's gate of each leaf's max (1e-5; RWKV-6's by the
    module doc), params within 1e-5."""
    got, want = _case(ranks, name, mesh, "steps")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    assert_leaves_close(got["mu"], want["mu"], _rtol(name))
    assert_step_close(got, want)


@pytest.mark.parametrize("name,mesh", PAIRS, ids=IDS)
def test_mixer_mesh_trajectory_matches_reference(ranks, name, mesh):
    got, want = _case(ranks, name, mesh, "steps")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(
        got["grad_norm"], want["grad_norm"],
        rtol=RWKV_TRAJ_GN_RTOL if name.startswith("rwkv6") else 1e-4)


@pytest.mark.parametrize("name,mesh", PAIRS, ids=IDS)
def test_mixer_mesh_microbatched_step_matches_reference(ranks, name, mesh):
    got, want = _case(ranks, name, mesh, "microbatches")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5)
    assert_leaves_close(got["mu"], want["mu"], _rtol(name))
    assert_step_close(got, want)


@pytest.mark.parametrize("name,mesh", LAYOUTS,
                         ids=[f"{n}-{_mesh_id(m)}" for n, m in LAYOUTS])
def test_mixer_holds_shards_and_computes_its_heads(ranks, name, mesh):
    """Layer 0 on (2, 2) and (1, 4): the rank holds its block of each
    leaf under ``param_specs``; where the heads split over ``model`` it
    computes with its heads' column blocks of the column-parallel leaves
    and their rows of ``wo`` (gathered over data only), every other leaf
    whole, and computes only its heads (RWKV-6's state, MLA's queries);
    where they do not (RWKV-6's 2 heads on 4 ranks) the mixer runs whole
    on every rank."""
    got = value(ranks[0], f"layout-{name}-{_mesh_id(mesh)}")
    cfg = jcfg(CONFIGS[name])
    D, H = cfg.d_model, cfg.n_heads
    n = mesh[1]
    held, used, mixer = got["held"]["mix"], got["compute"]["mix"], \
        got["mixer"]
    if (name, mesh) in ATTN_HEADS:
        hd, KV = cfg.head_dim, cfg.n_kv_heads
        assert got["tp"] == [True, True]
        kv_cols = KV * hd // n if KV % n == 0 else KV * hd
        assert held["wk"] == [D // mesh[0], KV * hd // n]
        assert used["wq"] == [D, H * hd // n]
        assert used["wk"] == used["wv"] == [D, kv_cols]
        assert used["wo"] == [H * hd // n, D]
        if cfg.attn.qkv_bias:
            assert used["bq"] == [H * hd] and used["bk"] == [KV * hd]
        q, k = ATTN_HEADS[name, mesh]
        assert mixer["q"] == [1, 4, q, hd]
        assert mixer["k"] == mixer["v"] == [1, 4, k, hd]
    elif name == "rwkv6-7b":
        nH = D // 64
        split = nH % n == 0
        assert got["tp"] == [split, True]
        cols = D // n if split else D
        assert held["wr"] == [D // mesh[0], D // n]
        for k in ("wr", "wk", "wv", "wg"):
            assert used[k] == [D, cols]
        assert used["wo"] == [cols, D]
        assert used["w_lora_a"] == [D, 64]
        for k, shape in (("mu", [5, D]), ("w_lora_b", [64, D]),
                         ("u", [nH, 64]), ("ln_x", [2, D])):
            assert held[k] == used[k] == shape
        assert mixer["state"] == [1, nH // n if split else nH, 64, 64]
        assert mixer["y"] == [1, 4, D]
    else:
        m = cfg.mla
        qk, kvw = m.nope_head_dim + m.rope_head_dim, m.nope_head_dim \
            + m.v_head_dim
        assert got["tp"] == [True, True]
        assert held["wq_b"] == [m.q_lora_rank // mesh[0], H * qk // n]
        assert used["wq_b"] == [m.q_lora_rank, H // n * qk]
        assert used["wkv_b"] == [m.kv_lora_rank, H // n * kvw]
        assert used["wo"] == [H // n * m.v_head_dim, D]
        assert used["wq_a"] == [D, m.q_lora_rank]
        assert used["wkv_a"] == [D, m.kv_lora_rank + m.rope_head_dim]
        assert mixer["q_nope"] == [1, 4, H // n, m.nope_head_dim]
        assert mixer["q_rope"] == [1, 4, H // n, m.rope_head_dim]


def test_mixer_gathers_only_its_blocks(ranks):
    """On (data 2, model 2) layer 0's mixer gathers, over data only, its
    column and row blocks (half of each) and its whole ``_FSDP0`` leaves
    (RWKV-6's ``w_lora_a``; MLA's ``wq_a`` and ``wkv_a``): its
    all-gather payload is those tensors' f32 bytes, and nothing else
    moves (the replicated leaves are held whole)."""
    cfg = jcfg("rwkv6-7b")
    D = cfg.d_model
    rwkv = 5 * D * D // 2 + D * 64
    got = value(ranks[0], "layout-rwkv6-7b-2x2")
    assert got["mix_bytes"] == {"all-gather": 4 * rwkv}
    cfg = jcfg("deepseek-v2-236b")
    D, H, m = cfg.d_model, cfg.n_heads, cfg.mla
    blocks = (m.q_lora_rank * H * (m.nope_head_dim + m.rope_head_dim)
              + m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
              + H * m.v_head_dim * D) // 2
    fsdp0 = D * (m.q_lora_rank + m.kv_lora_rank + m.rope_head_dim)
    got = value(ranks[0], "layout-deepseek-v2-236b-2x2")
    assert got["mix_bytes"] == {"all-gather": 4 * (blocks + fsdp0)}


@pytest.mark.parametrize("leaf", RWKV_SHARED)
def test_shared_rwkv6_leaf_gradients_match_reference(ranks, leaf):
    """On (2, 2) every ``model`` rank uses these leaves in part (``mu``
    and ``w_lora_a`` feed its heads' products, ``w_lora_b``, ``u`` and
    ``ln_x`` are cut to its heads): their gradients, summed over
    ``model`` once, within RWKV-6's gate (the module doc) of each leaf's
    max (the first moments) in every layer."""
    got, want = _case(ranks, "rwkv6-7b", (2, 2), "steps")
    for block_got, block_want in zip(got["mu"]["body"], want["mu"]["body"]):
        assert_leaves_close(block_got["mix"][leaf], block_want["mix"][leaf],
                            _rtol("rwkv6-7b")(leaf))
