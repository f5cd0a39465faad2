"""Split-K schedule of the absorbed-MLA kernel, on the CPU.

The CUDA kernel cuts each slot's pages into splits of ``MLA_SPLIT`` tokens
and merges the per-split softmax states in split order
(``repro_torch.kernels.mla_attention.split``).  These tests hold that
arithmetic, in plain PyTorch, against the Pallas kernel run in interpret
mode (the reference's own way on the CPU) and against the whole-range
plain version ``ref.mla_paged_ctx_ref``, at 2e-5 absolute (f32 sums in
other orders).  The kernel itself is held against the same plain versions
on the card (``tests/test_torch_kernels_cuda.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.mla_attention import mla_attention as jmla  # noqa: E402
from repro_torch.kernels.mla_attention import mla_attention as tmk  # noqa: E402
from repro_torch.kernels.mla_attention import ref  # noqa: E402
from repro_torch.kernels.mla_attention import split as sp  # noqa: E402
from repro_torch.models.attention import NEG_INF  # noqa: E402
from _torch_cases import MLA, MLA_SPLITS, mla_case, mla_split_case  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
KEYS = ("q_lat", "q_rope", "c", "kr", "stack", "lengths")


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def pallas(c):
    return np.asarray(jmla.mla_paged_ctx_fwd(
        *(jnp.asarray(c[k]) for k in KEYS), scale=c["scale"],
        interpret=True))


@pytest.mark.parametrize("keys,want", [(1, 1), (255, 1), (256, 1),
                                       (257, 2), (512, 2), (4096, 16)])
def test_split_count_covers_the_token_axis(keys, want):
    n = sp.num_splits(keys, sp.MLA_SPLIT)
    assert n == want
    assert (n - 1) * sp.MLA_SPLIT < keys <= n * sp.MLA_SPLIT


@pytest.mark.parametrize("length,nsplit,want", [
    (0, 2, 0), (1, 2, 0), (255, 2, 0), (256, 2, 0), (257, 2, 1),
    (512, 2, 1), (600, 2, 1), (2048, 8, 7)])
def test_last_split_names_the_split_of_the_last_token(length, nsplit, want):
    assert sp.last_split(length, sp.MLA_SPLIT, nsplit) == want


def test_scratch_is_sized_from_shapes():
    out = (8, 128, 512)                       # DeepSeek-V2: B 8, H 128
    assert sp.scratch_shapes(out, 1) is None
    po, pml = sp.scratch_shapes(out, 8)
    assert po == (8, 8, 128, 512) and pml == (8, 8, 128, 2)
    assert sp.scratch_bytes(out, 8) == 4 * 8 * 8 * 128 * 514


@pytest.mark.parametrize("split", [32, 256])
@pytest.mark.parametrize("case", MLA + MLA_SPLITS, ids=str)
def test_merged_partials_match_pallas_interpret(case, split):
    c = (mla_split_case(20, **case) if case in MLA_SPLITS
         else mla_case(20, **case))
    args = [t(c[k]) for k in KEYS]
    m, l, acc = sp.mla_partials_ref(*args, scale=c["scale"], split=split)
    got = sp.merge_partials(m, l, acc)
    np.testing.assert_allclose(got.numpy(), pallas(c), **TOL)
    np.testing.assert_allclose(
        got.numpy(), ref.mla_paged_ctx_ref(*args, scale=c["scale"]).numpy(),
        **TOL)
    # the CPU wrapper runs the whole-range plain version
    np.testing.assert_allclose(
        tmk.mla_paged_ctx_fwd(*args, scale=c["scale"]).numpy(),
        got.numpy(), **TOL)


@pytest.mark.parametrize("case", MLA_SPLITS, ids=str)
def test_split_edges_holes_and_empty_slots(case):
    """Splits past a slot's last token, and splits of holes, see nothing
    (m = NEG_INF, l = 0, acc = 0); merging only the splits up to
    ``last_split`` (as the kernel does) gives the same output; a slot of
    length 0 and an all-hole split come out exactly as the plain version,
    the empty slot exactly 0."""
    c = mla_split_case(21, **case)
    args = [t(c[k]) for k in KEYS]
    m, l, acc = sp.mla_partials_ref(*args, scale=c["scale"])
    nsplit = m.shape[0]
    assert nsplit == 2
    lengths = c["lengths"]
    for b, n in enumerate(lengths.tolist()):
        s1 = sp.last_split(n, sp.MLA_SPLIT, nsplit)
        for s in range(s1 + 1, nsplit):
            assert (m[s, b] == NEG_INF).all() and not l[s, b].any()
            assert not acc[s, b].any()
        part = sp.merge_partials(m[:s1 + 1, b], l[:s1 + 1, b],
                                 acc[:s1 + 1, b])
        np.testing.assert_allclose(
            part.numpy(), sp.merge_partials(m, l, acc)[b].numpy(), **TOL)
    # slot 5 (300 tokens) has split 1 made wholly of holes
    assert (m[1, 5] == NEG_INF).all() and not l[1, 5].any()
    got = sp.merge_partials(m, l, acc)
    assert not got[lengths == 0].any()
    np.testing.assert_allclose(got.numpy(), pallas(c), **TOL)
