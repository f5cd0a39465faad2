"""The CUDA kernels (paged attention, absorbed-MLA paged decode) against
their plain versions, on the card.  These skip without a CUDA device; on a machine with one run them
with ``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``
(the file imports no JAX)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mla_attention import mla_attention as tmk  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as tpa  # noqa: E402
from _torch_cases import (MLA, PAGED, RAGGED, mla_case, paged_case,  # noqa: E402
                          ragged_case)

TOL = dict(rtol=2e-5, atol=2e-5)


def t(a, device="cpu"):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED, ids=str)
def test_decode_kernel_matches_plain_on_card(cuda, case):
    c = paged_case(10, **case)
    B, H, hd = c["q"].shape
    KV = c["kv"].shape[2] // 2
    q = t(c["q"], cuda).reshape(B, KV, H // KV, hd)
    kv, stack, lengths = t(c["kv"], cuda), t(c["stack"], cuda), \
        t(c["lengths"], cuda)
    outs = [tpa.paged_attention_fused_fwd(q, kv, stack, lengths,
                                          window=c["window"], buffer_depth=d)
            for d in (1, 2, 4)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    split = tpa.paged_attention_fwd(q, kv[:, :, 0::2].contiguous(),
                                    kv[:, :, 1::2].contiguous(), stack,
                                    lengths, window=c["window"])
    plain = tpa.paged_attention_fused_fwd(q.cpu(), kv.cpu(), stack.cpu(),
                                          lengths.cpu(), window=c["window"])
    close(outs[0], plain.numpy())
    close(split, plain.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_ragged_kernel_matches_plain_on_card(cuda, case):
    c = ragged_case(11, **case)
    d = c["d"]
    args = [t(c["q"], cuda), t(c["kv"], cuda), t(c["stack"], cuda),
            t(d["tile_row"], cuda), t(d["tile_pos"], cuda),
            t(d["kv_lens"], cuda)]
    got = tops.ragged_paged_attention(*args, window=c["window"])
    plain = tops.ragged_paged_attention(*(a.cpu() for a in args),
                                        window=c["window"])
    real = t(d["token_row"] >= 0)
    assert torch.isfinite(got).all()
    close(got.cpu()[real], plain[real].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA, ids=str)
def test_mla_kernel_matches_plain_on_card(cuda, case):
    c = mla_case(12, **case)
    args = [t(c[k], cuda) for k in ("q_lat", "q_rope", "c", "kr", "stack",
                                    "lengths")]
    before = tmk.LAUNCHES["mla_ctx"]
    got = tmk.mla_paged_ctx_fwd(*args, scale=c["scale"])
    assert tmk.LAUNCHES["mla_ctx"] == before + 1
    plain = tmk.mla_paged_ctx_fwd(*(a.cpu() for a in args), scale=c["scale"])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    close(got, plain.numpy())
    seen_nothing = t((c["mono"] < 0).all(1) | (c["lengths"] == 0))
    assert not got.cpu()[seen_nothing].any()
