"""Split-K algebra of the paged-attention kernels, on the CPU (no JAX).

The CUDA kernels cut each slot's key axis into splits, keep an online
softmax per split and merge the partials by the log-sum-exp rule
(``repro_torch.kernels.paged_attention.split``).  These tests hold that
arithmetic, in plain PyTorch, against the whole-range plain versions in
``ref.py``: merged partials equal them, empty splits weigh exactly 0, and
the splits a unit's descriptor names (``unit_range``) are exactly the ones
holding its visible keys.  The kernels themselves are held against the
same plain versions on the card (``tests/test_torch_kernels_cuda.py``).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention import ref  # noqa: E402
from repro_torch.kernels.paged_attention import split as sp  # noqa: E402
from repro_torch.models.attention import NEG_INF  # noqa: E402
from _torch_cases import (PAGED, PAGED_SPLITS, RAGGED, RAGGED_SPLITS,  # noqa: E402
                          paged_case, paged_split_case, ragged_case,
                          ragged_split_case)

TOL = dict(rtol=1e-6, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def visible_splits(qpos0, qrows, kv_len, window, split):
    """Brute force: the splits holding a key some row of the unit sees."""
    out = set()
    for qpos in range(qpos0, qpos0 + qrows):
        lo = max(0, qpos - window + 1) if window else 0
        for k in range(lo, min(qpos, kv_len - 1) + 1):
            out.add(k // split)
    return out


@pytest.mark.parametrize("split", [32, 64, 256])
def test_unit_range_names_exactly_the_visible_splits(split):
    rng = np.random.RandomState(split)
    for _ in range(300):
        qrows = int(rng.choice([1, 8]))
        kv_len = int(rng.randint(0, 700))
        qpos0 = int(rng.randint(0, 720))
        window = int(rng.choice([0, 1, 40, 300]))
        s0, s1 = sp.unit_range(qpos0, qrows, kv_len, window or None, split)
        want = visible_splits(qpos0, qrows, kv_len, window, split)
        if want:
            assert (s0, s1) == (min(want), max(want))
            assert want == set(range(s0, s1 + 1))
        else:
            assert (s0, s1) == (0, 0)


@pytest.mark.parametrize("keys,split,want", [
    (1, 256, 1), (256, 256, 1), (257, 256, 2), (4096, 256, 16),
    (4096, 608, 7), (2560, 512, 5)])
def test_num_splits_covers_the_key_axis(keys, split, want):
    n = sp.num_splits(keys, split)
    assert n == want
    assert (n - 1) * split < keys <= n * split


def test_scratch_shapes_and_bytes():
    out = (2048, 8, 4, 128)
    assert sp.scratch_shapes(out, 1) is None
    assert sp.scratch_bytes(out, 1) == 0
    po, pml = sp.scratch_shapes(out, 3)
    assert po == (3, 2048, 8, 4, 128) and pml == (3, 2048, 8, 4, 2)
    assert sp.scratch_bytes(out, 3) == 4 * 3 * 2048 * 8 * 4 * (128 + 2)


@pytest.mark.parametrize("keys,out", [
    (4096, (2048, 8, 4, 128)),       # the kernel check's shapes: capped
    (2560, (2048, 8, 4, 128)),       # granite's engine step: not capped
    (4224, (128, 2, 4, 128)),        # the on-card test cases
    (131072, (4096, 8, 5, 128)),
    (512, (8, 1, 1, 4))])
def test_ragged_split_keeps_scratch_under_the_cap(keys, out):
    split = sp.ragged_split(keys, out)
    n = sp.num_splits(keys, split)
    assert split % 32 == 0 and n * split >= keys
    assert split >= sp.RAGGED_SPLIT
    assert sp.scratch_bytes(out, n) <= sp.RAGGED_SCRATCH_CAP or n == 1
    if sp.scratch_bytes(out, sp.num_splits(keys, sp.RAGGED_SPLIT)) \
            <= sp.RAGGED_SCRATCH_CAP:
        assert split == sp.RAGGED_SPLIT


def test_split_cases_use_the_uncapped_splits():
    c = ragged_split_case(0, G=5, KV=2, hd=128, W=4)
    bs = c["kv"].shape[1]
    keys = c["stack"].shape[-1] * bs
    out = (c["q"].shape[0], 2, 5, 128)
    assert sp.ragged_split(keys, out) == sp.RAGGED_SPLIT
    assert sp.num_splits(keys, sp.RAGGED_SPLIT) >= 4
    c = paged_split_case(0, G=4, KV=2, hd=128, W=1)
    assert sp.num_splits(c["stack"].shape[-1] * bs, sp.DECODE_SPLIT) >= 4


def test_merge_weighs_empty_splits_zero_and_empty_rows_zero():
    acc = torch.randn(3, 2, 4)
    m = torch.tensor([[0.5, NEG_INF], [NEG_INF, NEG_INF], [2.0, NEG_INF]])
    l = torch.tensor([[1.5, 0.0], [0.0, 0.0], [2.5, 0.0]])
    acc[1] = 0.0
    acc[:, 1] = 0.0
    got = sp.merge_partials(m, l, acc)
    w0, w2 = np.exp(0.5 - 2.0), 1.0
    want = (w0 * acc[0, 0] + w2 * acc[2, 0]) / (w0 * 1.5 + w2 * 2.5)
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-6)
    assert torch.equal(got[1], torch.zeros(4))
    # dropping the empty split changes nothing, bit for bit
    assert torch.equal(sp.merge_partials(m[[0, 2]], l[[0, 2]], acc[[0, 2]]),
                       got)


def _decode_inputs(c):
    B, H, hd = c["q"].shape
    KV = c["kv"].shape[2] // 2
    return (t(c["q"]).reshape(B, KV, H // KV, hd), t(c["kv"]), t(c["stack"]),
            t(c["lengths"]))


def _check_decode(c, split):
    q, kv, stack, lengths = _decode_inputs(c)
    B, KV, G, hd = q.shape
    window = c["window"]
    m, l, acc = sp.decode_partials_ref(q, kv, stack, lengths, window=window,
                                       split=split)
    want = ref.paged_decode_attention_fused_ref(
        q.reshape(B, KV * G, hd), kv, stack, lengths,
        window=window).reshape(B, KV, G, hd)
    got = sp.merge_partials(m, l, acc)
    active = lengths > 0
    np.testing.assert_allclose(got[active].numpy(), want[active].numpy(),
                               **TOL)
    assert torch.equal(got[~active], torch.zeros_like(got[~active]))
    bs = kv.shape[1]
    for b in range(B):
        n = int(lengths[b])
        s0, s1 = sp.unit_range(n - 1, 1, n, window, split)
        touched = set(range(s0, s1 + 1)) if n else set()
        for j in range(m.shape[0]):
            if j not in touched:          # its CTA exits without writing
                assert not l[j, b].any() and not acc[j, b].any()
        if s0 == s1 and n:                # written directly, no merge
            direct = acc[s0, b] / l[s0, b].clamp(min=1e-30)[..., None]
            np.testing.assert_allclose(direct.numpy(), want[b].numpy(), **TOL)
    return m, l, bs


@pytest.mark.parametrize("case,split", list(itertools.product(PAGED,
                                                              [64, 256])),
                         ids=str)
def test_merged_decode_partials_equal_the_plain_version(case, split):
    _check_decode(paged_case(10, **case), split)


@pytest.mark.parametrize("case", PAGED_SPLITS, ids=str)
def test_merged_decode_partials_over_many_splits(case):
    c = paged_split_case(16, **case)
    S = sp.DECODE_SPLIT
    m, l, _ = _check_decode(c, S)
    # slot 3 (length 4S + 1) has split 1 made of holes: an empty partial
    if c["window"] is None:
        assert not l[1, 3].any()
        assert (m[1, 3] == NEG_INF).all()
    else:                                  # a window shorter than a split
        assert c["window"] < S
        n = int(c["lengths"][3])
        lo = n - c["window"]
        for j in range(m.shape[0]):
            if j < lo // S or j > (n - 1) // S:
                assert not l[j, 3].any()


def _check_ragged(c, split):
    d = c["d"]
    T, H, hd = c["q"].shape
    KV = c["kv"].shape[2] // 2
    q = t(c["q"]).reshape(T, KV, H // KV, hd)
    kv, stack = t(c["kv"]), t(c["stack"])
    row, pos, kv_lens = t(d["token_row"]), t(d["token_pos"]), t(d["kv_lens"])
    window = c["window"]
    m, l, acc = sp.ragged_partials_ref(q, kv, stack, row, pos, kv_lens,
                                       window=window, split=split)
    want = ref.ragged_fused_ref(q.reshape(T, H, hd), kv, stack, row, pos,
                                kv_lens, window=window).reshape(q.shape)
    got = sp.merge_partials(m, l, acc)
    real = row >= 0
    np.testing.assert_allclose(got[real].numpy(), want[real].numpy(), **TOL)
    assert not got[~real].any()
    from repro_torch.kernels.paged_attention.ops import QT
    for tile in range(T // QT):
        slot = int(d["tile_row"][tile])
        kvn = int(d["kv_lens"][slot]) if slot >= 0 else 0
        s0, s1 = sp.unit_range(int(d["tile_pos"][tile]), QT, kvn, window,
                               split)
        rows = slice(tile * QT, (tile + 1) * QT)
        for j in range(m.shape[0]):
            if not s0 <= j <= s1:
                assert not l[j, rows].any()
    return m, l


@pytest.mark.parametrize("case,split", list(itertools.product(RAGGED,
                                                              [32, 128])),
                         ids=str)
def test_merged_ragged_partials_equal_the_plain_version(case, split):
    _check_ragged(ragged_case(11, **case), split)


@pytest.mark.parametrize("case", RAGGED_SPLITS, ids=str)
def test_merged_ragged_partials_over_many_splits(case):
    c = ragged_split_case(17, **case)
    S = sp.RAGGED_SPLIT
    m, l = _check_ragged(c, S)
    row = c["d"]["token_row"]
    (r5,) = np.nonzero(row == 5)          # the decode row at 3000
    if c["window"] is None:               # split 1 of slot 5 is all holes
        assert not l[1, r5].any()
        assert (m[1, r5] == NEG_INF).all()
    (r0,) = np.nonzero(row == 0)          # the lone row at 4200
    assert (l[:, r0] > 0).any(dim=-1).any(dim=-1).sum() >= (
        1 if c["window"] else 4)
