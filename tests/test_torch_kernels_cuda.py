"""The CUDA kernels (paged attention, absorbed-MLA paged decode, the Mamba
and RWKV-6 scans, flash attention) against their plain versions, on the
card, the training path there (the chunked attention's backward
against autograd through direct attention, one train step), the decode
tuner, and the SP decode on two gloo ranks sharing the card.  These skip
without a CUDA device; on a machine with one run them
with ``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``
(the file imports no JAX)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as tfops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan as tms  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as tmsops  # noqa: E402
from repro_torch.kernels.mla_attention import mla_attention as tmk  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as tpa  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as trkops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as trk  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mla_attention import ref as tmref  # noqa: E402
from repro_torch.kernels.mla_attention import split as tmsplit  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as trkref  # noqa: E402
from _torch_cases import (BF16_PAIRS, FLASH, MAMBA, MLA,  # noqa: E402
                          MLA_SPLITS, PAGED, PAGED_HD36, PAGED_SPLITS,
                          RAGGED, RAGGED_HD36, RAGGED_SPLITS, RWKV6,
                          RWKV6_CHUNKED, flash_case, mamba_case, mla_case,
                          mla_split_case, paged_case, paged_split_case,
                          ragged_case, ragged_split_case, rand, rwkv6_case,
                          rwkv6_strong_case)

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
@pytest.mark.parametrize("case", PAGED_SPLITS, ids=str)
def test_decode_kernel_splits_match_plain_on_card(cuda, case):
    """Key axes of five splits: lengths at a split's edges, a split of
    holes, windows shorter than a split; depths bit-identical, the split
    pools equal to the fused pool's result, an inactive slot exact 0."""
    c = paged_split_case(16, **case)
    B, H, hd = c["q"].shape
    KV = c["kv"].shape[2] // 2
    q = t(c["q"], cuda).reshape(B, KV, H // KV, hd)
    kv, stack, lengths = t(c["kv"], cuda), t(c["stack"], cuda), \
        t(c["lengths"], cuda)
    before = tpa.LAUNCHES["paged_decode"]
    outs = [tpa.paged_attention_fused_fwd(q, kv, stack, lengths,
                                          window=c["window"], buffer_depth=d)
            for d in (1, 2, 4)]
    split = tpa.paged_attention_fwd(q, kv[:, :, 0::2].contiguous(),
                                    kv[:, :, 1::2].contiguous(), stack,
                                    lengths, window=c["window"])
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["paged_decode"] == before + 4
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    plain = tpa.paged_attention_fused_fwd(q.cpu(), kv.cpu(), stack.cpu(),
                                          lengths.cpu(), window=c["window"])
    active = t(c["lengths"] > 0)
    for got in (outs[0], split):
        assert torch.isfinite(got).all()
        close(got.cpu()[active], plain[active].numpy())
    assert torch.equal(outs[0].cpu()[~active],
                       torch.zeros_like(plain[~active]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED_SPLITS, ids=str)
def test_ragged_kernel_splits_match_plain_on_card(cuda, case):
    """A mixed batch over five splits (see ``ragged_split_case``): real
    rows match the plain version, padding rows and tiles come out 0."""
    c = ragged_split_case(17, **case)
    d = c["d"]
    args = [t(c["q"], cuda), t(c["kv"], cuda), t(c["stack"], cuda),
            t(d["tile_row"], cuda), t(d["tile_pos"], cuda),
            t(d["kv_lens"], cuda)]
    got = _launched(tpa, "ragged", lambda: tops.ragged_paged_attention(
        *args, window=c["window"]))
    again = tops.ragged_paged_attention(*args, window=c["window"])
    plain = tops.ragged_paged_attention(*(a.cpu() for a in args),
                                        window=c["window"])
    real = t(d["token_row"] >= 0)
    assert torch.equal(got, again)
    close(got.cpu()[real], plain[real].numpy())
    assert not got.cpu()[~real].any()


# ------------------------------------------------ bf16 pools and queries
# The kernels upcast every element to f32 where they read it and compute
# in f32, as the TPU kernels do, so a call in any (q, pool) pair of
# element types equals the f32 kernel on the upcast inputs, rounded once
# to q's type: bit for bit, no tolerance.
PAGED_DTYPE_CASES = ([("paged", c) for c in PAGED]
                     + [("split", c) for c in PAGED_SPLITS]
                     + [("paged", c) for c in PAGED_HD36])
RAGGED_DTYPE_CASES = ([("ragged", c) for c in RAGGED]
                      + [("split", c) for c in RAGGED_SPLITS]
                      + [("ragged", c) for c in RAGGED_HD36])


def _decode_inputs(kind, case, cuda):
    c = (paged_split_case(26, **case) if kind == "split"
         else paged_case(26, **case))
    B, H, hd = c["q"].shape
    KV = c["kv"].shape[2] // 2
    return (t(c["q"], cuda).reshape(B, KV, H // KV, hd), t(c["kv"], cuda),
            t(c["stack"], cuda), t(c["lengths"], cuda), c["window"])


def _ragged_inputs(kind, case, cuda):
    """q (T, H, hd), pool, stack, tile_row, tile_pos, kv_lens (one per slot:
    ``ops.ragged_paged_attention`` pads them to the stack's slots), window."""
    c = (ragged_split_case(27, **case) if kind == "split"
         else ragged_case(27, **case))
    d = c["d"]
    return (t(c["q"], cuda), t(c["kv"], cuda), t(c["stack"], cuda),
            t(d["tile_row"], cuda), t(d["tile_pos"], cuda),
            t(d["kv_lens"], cuda), c["window"])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,pool_dtype", BF16_PAIRS)
@pytest.mark.parametrize("kind,case", PAGED_DTYPE_CASES, ids=str)
def test_decode_kernel_in_bf16_is_the_f32_kernel_rounded_on_card(
        cuda, kind, case, q_dtype, pool_dtype):
    """Fused at depths 1/2/4 (bit-identical) and over split pools: the
    output has q's dtype and equals the f32 kernel on the upcast inputs
    rounded to it."""
    qd, pd = getattr(torch, q_dtype), getattr(torch, pool_dtype)
    q, kv, stack, lengths, window = _decode_inputs(kind, case, cuda)
    q, kv = q.to(qd), kv.to(pd)
    kp, vp = kv[:, :, 0::2].contiguous(), kv[:, :, 1::2].contiguous()
    before = tpa.LAUNCHES["paged_decode"]
    outs = [tpa.paged_attention_fused_fwd(q, kv, stack, lengths,
                                          window=window, buffer_depth=d)
            for d in (1, 2, 4)]
    split = tpa.paged_attention_fwd(q, kp, vp, stack, lengths, window=window)
    want = tpa.paged_attention_fused_fwd(q.float(), kv.float(), stack,
                                         lengths, window=window).to(qd)
    want_split = tpa.paged_attention_fwd(q.float(), kp.float(), vp.float(),
                                         stack, lengths,
                                         window=window).to(qd)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["paged_decode"] == before + 6
    for got in (*outs, split):
        assert got.dtype == qd and torch.isfinite(got).all()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], want)
    assert torch.equal(split, want_split)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,pool_dtype", BF16_PAIRS)
@pytest.mark.parametrize("kind,case", RAGGED_DTYPE_CASES, ids=str)
def test_ragged_kernel_in_bf16_is_the_f32_kernel_rounded_on_card(
        cuda, kind, case, q_dtype, pool_dtype):
    """Every row, padding included: the output has q's dtype and equals
    the f32 kernel on the upcast inputs rounded to it."""
    qd, pd = getattr(torch, q_dtype), getattr(torch, pool_dtype)
    q, kv, stack, trow, tpos, kvl, window = _ragged_inputs(kind, case, cuda)
    q, kv = q.to(qd), kv.to(pd)
    got = _launched(tpa, "ragged", lambda: tops.ragged_paged_attention(
        q, kv, stack, trow, tpos, kvl, window=window))
    want = tops.ragged_paged_attention(q.float(), kv.float(), stack, trow,
                                       tpos, kvl, window=window).to(qd)
    torch.cuda.synchronize()
    assert got.dtype == qd and torch.isfinite(got).all()
    assert torch.equal(got, want)


# flash and MLA: the same rule, with q (and flash's output) and k/v, or
# the queries and the pools, each f32 or bf16; MLA's context stays f32
FLASH_DTYPE_CASES = FLASH
MLA_DTYPE_CASES = ([("mla", c) for c in MLA]
                   + [("split", c) for c in MLA_SPLITS])


def _mla_inputs(kind, case, cuda):
    """q_lat, q_rope, c_pool, rope_pool, stack, lengths on the card, and
    the scale."""
    c = (mla_split_case(28, **case) if kind == "split"
         else mla_case(28, **case))
    return ([t(c[k], cuda) for k in ("q_lat", "q_rope", "c", "kr", "stack",
                                     "lengths")], c["scale"])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", BF16_PAIRS)
@pytest.mark.parametrize("case", FLASH_DTYPE_CASES, ids=str)
def test_flash_kernel_in_bf16_is_the_f32_kernel_rounded_on_card(
        cuda, case, q_dtype, kv_dtype):
    """Through ``ops.flash_attention`` on (B, S, H, hd) tensors: the output
    has q's dtype and equals the f32 kernel on the upcast inputs rounded
    to it."""
    qd, kd = getattr(torch, q_dtype), getattr(torch, kv_dtype)
    c = flash_case(29, **case)
    q, k, v = (t(c[n], cuda) for n in "qkv")
    q, k, v = q.to(qd), k.to(kd), v.to(kd)
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_offset"])
    got = _launched(tfa, "flash_attention",
                    lambda: tfops.flash_attention(q, k, v, **kw))
    want = tfops.flash_attention(q.float(), k.float(), v.float(),
                                 **kw).to(qd)
    torch.cuda.synchronize()
    assert got.dtype == qd and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,pool_dtype", BF16_PAIRS)
@pytest.mark.parametrize("kind,case", MLA_DTYPE_CASES, ids=str)
def test_mla_kernel_in_bf16_is_the_f32_kernel_on_card(cuda, kind, case,
                                                      q_dtype, pool_dtype):
    """The context is f32 and equals the f32 kernel on the upcast inputs,
    bit for bit; a slot that sees nothing is exactly 0."""
    qd, pd = getattr(torch, q_dtype), getattr(torch, pool_dtype)
    (ql, qr, cp, kr, stack, lengths), scale = _mla_inputs(kind, case, cuda)
    ql, qr, cp, kr = ql.to(qd), qr.to(qd), cp.to(pd), kr.to(pd)
    got = _launched(tmk, "mla_ctx", lambda: tmk.mla_paged_ctx_fwd(
        ql, qr, cp, kr, stack, lengths, scale=scale))
    want = tmk.mla_paged_ctx_fwd(ql.float(), qr.float(), cp.float(),
                                 kr.float(), stack, lengths, scale=scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert not got[lengths == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float16", "float64"])
@pytest.mark.parametrize("which", ["q", "pool"])
def test_kernels_refuse_other_dtypes_on_card(cuda, bad, which):
    """f16 and f64 raise ValueError naming what the kernels take: no cast,
    no plain run, no launch.  The paged kernels, flash (``pool``: k and v)
    and MLA (``pool``: the latent and rope pools)."""
    bd = getattr(torch, bad)
    q, kv, stack, lengths, _ = _decode_inputs("paged", PAGED[0], cuda)
    rq, rkv, rstack, trow, tpos, kvl, _ = _ragged_inputs("ragged",
                                                         RAGGED[0], cuda)
    c = flash_case(30, **FLASH[0])
    fq, fk, fv = (t(c[n], cuda) for n in "qkv")
    (ql, qr, cp, kr, mstack, mlen), scale = _mla_inputs("mla", MLA[0], cuda)
    if which == "q":
        q, rq, fq, ql, qr = (x.to(bd) for x in (q, rq, fq, ql, qr))
    else:
        kv, rkv, fk, fv, cp, kr = (x.to(bd) for x in (kv, rkv, fk, fv, cp,
                                                      kr))
    kp, vp = kv[:, :, 0::2].contiguous(), kv[:, :, 1::2].contiguous()
    before = launch_counts()
    calls = (lambda: tpa.paged_attention_fused_fwd(q, kv, stack, lengths),
             lambda: tpa.paged_attention_fwd(q, kp, vp, stack, lengths),
             lambda: tops.ragged_paged_attention(rq, rkv, rstack, trow, tpos,
                                                 kvl),
             lambda: tfops.flash_attention(fq, fk, fv),
             lambda: tmk.mla_paged_ctx_fwd(ql, qr, cp, kr, mstack, mlen,
                                           scale=scale))
    for call in calls:
        with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
            call()
    assert launch_counts() == before


def launch_counts() -> dict:
    return {**tpa.LAUNCHES, **tfa.LAUNCHES, **tmk.LAUNCHES}


@pytest.mark.cuda
def test_inputs_of_two_dtypes_are_refused_on_card(cuda):
    """Flash's k and v share one dtype, as do MLA's queries and its two
    pools."""
    c = flash_case(31, **FLASH[0])
    q, k, v = (t(c[n], cuda) for n in "qkv")
    (ql, qr, cp, kr, stack, lengths), scale = _mla_inputs("mla", MLA[0],
                                                          cuda)
    before = launch_counts()
    with pytest.raises(ValueError, match="v has dtype"):
        tfops.flash_attention(q, k, v.bfloat16())
    with pytest.raises(ValueError, match="rope_pool has dtype"):
        tmk.mla_paged_ctx_fwd(ql, qr, cp.bfloat16(), kr, stack, lengths,
                              scale=scale)
    with pytest.raises(ValueError, match="q_rope has dtype"):
        tmk.mla_paged_ctx_fwd(ql.bfloat16(), qr, cp, kr, stack, lengths,
                              scale=scale)
    assert launch_counts() == before


class _Spy:
    """Stands in for a wrapper's library: records each call of ``name``'s
    arguments, then makes it."""

    def __init__(self, lib, name):
        self.lib, self.name, self.calls = lib, name, []

    def __getattr__(self, attr):
        fn = getattr(self.lib, attr)
        if attr != self.name:
            return fn

        def call(*args):
            self.calls.append(args)
            return fn(*args)
        return call


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [36, 120, 128])
def test_bf16_inputs_reach_the_kernels_without_a_copy_on_card(cuda, hd,
                                                              monkeypatch):
    """Aligned bf16 inputs reach the launch by their own ``data_ptr()``
    and bf16's dtype code: flash on the transposed views of (B, S, H, hd)
    tensors (hd 36: rows 8 bytes off 16, copied 8 bytes at a time), MLA
    on the decode path's (f32 queries, bf16 pools) and on bf16 queries."""
    bf = tpa.DTYPE_CODES[torch.bfloat16]
    c = flash_case(32, B=2, Sq=150, Sk=150, H=4, KV=2, hd=hd, causal=True,
                   window=None)
    q, k, v = (t(c[n], cuda).bfloat16() for n in "qkv")
    spy = _Spy(tfa._lib(), "flash_attention_launch")
    monkeypatch.setattr(tfa, "_lib", lambda: spy)
    got = _launched(tfa, "flash_attention",
                    lambda: tfops.flash_attention(q, k, v))
    (args,) = spy.calls
    assert args[:2] == (bf, bf)
    assert args[2:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         got.data_ptr())
    assert got.dtype == torch.bfloat16 and got.is_contiguous()

    (ql, qr, cp, kr, stack, lengths), scale = _mla_inputs("mla", MLA[4],
                                                          cuda)
    cp, kr = cp.bfloat16(), kr.bfloat16()
    spy = _Spy(tmk._lib(), "mla_ctx_launch")
    monkeypatch.setattr(tmk, "_lib", lambda: spy)
    for qd in (torch.float32, torch.bfloat16):
        qlt, qrt = ql.to(qd), qr.to(qd)
        _launched(tmk, "mla_ctx", lambda: tmk.mla_paged_ctx_fwd(
            qlt, qrt, cp, kr, stack, lengths, scale=scale))
        args = spy.calls[-1]
        assert args[:2] == (tpa.DTYPE_CODES[qd], bf)
        assert args[2:6] == (qlt.data_ptr(), qrt.data_ptr(), cp.data_ptr(),
                             kr.data_ptr())


@pytest.mark.cuda
def test_split_pools_of_two_dtypes_are_refused_on_card(cuda):
    q, kv, stack, lengths, _ = _decode_inputs("paged", PAGED[0], cuda)
    kp, vp = kv[:, :, 0::2].contiguous(), kv[:, :, 1::2].contiguous()
    with pytest.raises(ValueError, match="v_pool has dtype"):
        tpa.paged_attention_fwd(q, kp, vp.to(torch.bfloat16), stack, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "pool"])
def test_entry_points_refuse_an_unknown_dtype_code_on_card(cuda, which,
                                                          monkeypatch):
    """``paged_decode_launch`` and ``ragged_launch`` return an error for a
    dtype code they do not know (here bf16's code replaced by 7), and the
    wrappers raise it: a buffer is never read as another type."""
    q, kv, stack, lengths, _ = _decode_inputs("paged", PAGED[0], cuda)
    rq, rkv, rstack, trow, tpos, kvl, _ = _ragged_inputs("ragged",
                                                         RAGGED[0], cuda)
    if which == "q":
        q, rq = q.bfloat16(), rq.bfloat16()
    else:
        kv, rkv = kv.bfloat16(), rkv.bfloat16()
    monkeypatch.setitem(tpa.DTYPE_CODES, torch.bfloat16, 7)
    before = dict(tpa.LAUNCHES)
    with pytest.raises(RuntimeError, match="paged_decode_kernel launch "
                                           "failed: CUDA error"):
        tpa.paged_attention_fused_fwd(q, kv, stack, lengths)
    with pytest.raises(RuntimeError, match="ragged_kernel launch failed: "
                                           "CUDA error"):
        tops.ragged_paged_attention(rq, rkv, rstack, trow, tpos, kvl)
    assert dict(tpa.LAUNCHES) == before


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


def _launched(module, key, fn):
    """fn() on the card, asserting it launched its kernel exactly once."""
    before = module.LAUNCHES[key]
    out = fn()
    torch.cuda.synchronize()
    assert module.LAUNCHES[key] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", MAMBA, ids=str)
def test_mamba_scan_kernel_matches_plain_on_card(cuda, case):
    c = mamba_case(13, **case)
    args = [t(c[k], cuda) for k in ("dt", "A", "B", "C", "x", "h0")]
    y, h = _launched(tms, "mamba_scan", lambda: tmsops.mamba_scan(
        *args, chunk=c["chunk"]))
    wy, wh = tmsops.mamba_scan(*(a.cpu() for a in args), chunk=c["chunk"])
    for got, want in ((y, wy), (h, wh)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RWKV6, ids=str)
def test_rwkv6_scan_kernel_matches_plain_on_card(cuda, case):
    c = rwkv6_case(14, **case)
    args = [t(c[k], cuda) for k in ("r", "k", "v", "w", "u", "S0")]
    y, s = _launched(trk, "rwkv6_scan", lambda: trkops.rwkv6_scan(
        *args, chunk=c["chunk"]))
    wy, ws = trkops.rwkv6_scan(*(a.cpu() for a in args), chunk=c["chunk"])
    for got, want in ((y, wy), (s, ws)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_kernel_matches_plain_on_card(cuda, case):
    c = flash_case(15, **case)
    args = [t(c[k], cuda) for k in ("q", "k", "v")]
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_offset"])
    got = _launched(tfa, "flash_attention",
                    lambda: tfops.flash_attention(*args, **kw))
    close(got, tfops.flash_attention(*(a.cpu() for a in args),
                                     **kw).numpy())


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_require_grad(cuda):
    q = torch.randn(1, 64, 2, 16, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        tfops.flash_attention(q, q, q)
    with torch.no_grad():
        assert torch.isfinite(tfops.flash_attention(q, q, q)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA_SPLITS, ids=str)
def test_mla_kernel_splits_match_plain_on_card(cuda, case):
    """Two splits of 256 tokens: lengths 1, 255, 256 and 257, holes across
    the split boundary, a split made wholly of holes, a slot of length 0
    (exact 0); H below, above and at 16 heads a block; W in {1, 4}."""
    c = mla_split_case(18, **case)
    args = [t(c[k], cuda) for k in ("q_lat", "q_rope", "c", "kr", "stack",
                                    "lengths")]
    got = _launched(tmk, "mla_ctx", lambda: tmk.mla_paged_ctx_fwd(
        *args, scale=c["scale"]))
    again = tmk.mla_paged_ctx_fwd(*args, scale=c["scale"])
    cpu = [a.cpu() for a in args]
    plain = tmref.mla_paged_ctx_ref(*cpu, scale=c["scale"])
    merged = tmsplit.merge_partials(*tmsplit.mla_partials_ref(
        *cpu, scale=c["scale"]))
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    close(got, plain.numpy())
    close(got, merged.numpy())
    assert not got.cpu()[t(c["lengths"] == 0)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case,col_split", RWKV6_CHUNKED, ids=str)
def test_rwkv6_kernel_col_splits_match_sequential_on_card(cuda, case,
                                                          col_split,
                                                          monkeypatch):
    """Every column split the kernel takes, tails of S not a multiple of
    32, head sizes 16/32/64: within 2e-4 x max(1, |want|) of the
    sequential oracle (the reference's tolerance)."""
    c = rwkv6_case(19, **case)
    monkeypatch.setattr(trk, "_COL_SPLIT", col_split)
    assert trk.col_split(case["hd"]) == col_split
    args = [t(c[k], cuda) for k in ("r", "k", "v", "w", "u", "S0")]
    y, s = _launched(trk, "rwkv6_scan", lambda: trkops.rwkv6_scan(*args))
    wy, ws = trkref.rwkv6_scan_ref(*(a.cpu() for a in args))
    for got, want in ((y, wy), (s, ws)):
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=2e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_w", [False, True])
def test_rwkv6_kernel_strong_decay_takes_the_sequential_path_on_card(
        cuda, zero_w):
    """Chunks past the decay limit (log w down to -5, and a w of exactly
    0) run the kernel's sequential path: finite, and within the
    reference's tolerance of the oracle."""
    c = rwkv6_strong_case(20, B=2, S=75, nH=4, hd=64, zero_w=zero_w)
    args = [t(c[k], cuda) for k in ("r", "k", "v", "w", "u", "S0")]
    assert not trkref.fast_chunks(args[3].cpu()).all()
    y, s = _launched(trk, "rwkv6_scan", lambda: trkops.rwkv6_scan(*args))
    wy, ws = trkref.rwkv6_scan_ref(*(a.cpu() for a in args))
    for got, want in ((y, wy), (s, ws)):
        assert torch.isfinite(got).all()
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=2e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["token_major", "strided", "unaligned"])
def test_rwkv6_op_reads_token_major_strides_on_card(cuda, layout):
    """``ops.rwkv6_scan`` hands the kernel token-major views: contiguous
    (B, S, nH, hd), heads taken out of a wider tensor (other strides), or
    rows off 16-byte alignment (copied first); y comes back token-major
    and equal to the oracle's."""
    c = rwkv6_case(21, B=2, S=45, nH=3, hd=32)
    base = [t(c[k], cuda) for k in ("r", "k", "v", "w")]
    if layout == "strided":
        base = [torch.cat([x, torch.ones_like(x)], dim=2)[:, :, :3]
                for x in base]
    elif layout == "unaligned":
        base = [torch.cat([torch.ones_like(x[..., :1]), x], dim=-1)[..., 1:]
                for x in base]
    args = [*base, t(c["u"], cuda), t(c["S0"], cuda)]
    y, s = _launched(trk, "rwkv6_scan", lambda: trkops.rwkv6_scan(*args))
    assert y.shape == (2, 45, 3, 32)
    wy, ws = trkref.rwkv6_scan_ref(*(a.cpu() for a in args))
    for got, want in ((y, wy), (s, ws)):
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=2e-4 * scale)


@pytest.mark.cuda
def test_wrappers_raise_when_the_library_fails_to_load(cuda, monkeypatch):
    """No silent plain run on the card: a wrapper whose library does not
    build or load raises, and counts no launch."""
    def broken(sources):
        raise RuntimeError("nvcc failed (test)")
    monkeypatch.setattr(_build, "load", broken)
    for mod in (tmk, trk, tpa):
        mod._lib.cache_clear()
    try:
        m = mla_case(22, **MLA[0])
        margs = [t(m[k], cuda) for k in ("q_lat", "q_rope", "c", "kr",
                                         "stack", "lengths")]
        r = rwkv6_case(22, **RWKV6[0])
        rargs = [t(r[k], cuda) for k in ("r", "k", "v", "w", "u", "S0")]
        before = (tmk.LAUNCHES["mla_ctx"], trk.LAUNCHES["rwkv6_scan"])
        with pytest.raises(RuntimeError, match="nvcc failed"):
            tmk.mla_paged_ctx_fwd(*margs, scale=m["scale"])
        with pytest.raises(RuntimeError, match="nvcc failed"):
            trkops.rwkv6_scan(*rargs)
        assert (tmk.LAUNCHES["mla_ctx"], trk.LAUNCHES["rwkv6_scan"]) == before
        # the paged kernels, on bf16 pools and queries as on f32 ones
        q, kv, stack, lengths, _ = _decode_inputs("paged", PAGED[0], cuda)
        rq, rkv, rstack, trow, tpos, kvl, _ = _ragged_inputs(
            "ragged", RAGGED[0], cuda)
        paged = dict(tpa.LAUNCHES)
        for qd, pd in [("float32", "float32"), *BF16_PAIRS]:
            qd, pd = getattr(torch, qd), getattr(torch, pd)
            with pytest.raises(RuntimeError, match="nvcc failed"):
                tpa.paged_attention_fused_fwd(q.to(qd), kv.to(pd), stack,
                                              lengths)
            with pytest.raises(RuntimeError, match="nvcc failed"):
                tops.ragged_paged_attention(rq.to(qd), rkv.to(pd), rstack,
                                            trow, tpos, kvl)
        assert dict(tpa.LAUNCHES) == paged
    finally:
        monkeypatch.undo()
        for mod in (tmk, trk, tpa):
            mod._lib.cache_clear()


def _scaled_close(got, want, tol):
    """Within tol x max(1, max|want|) (the reference's scan tolerance)."""
    scale = max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["x_proj", "x_proj_unaligned",
                                    "unaligned", "batch_of_one"])
def test_mamba_op_reads_strides_on_card(cuda, layout):
    """``ops.mamba_scan`` hands the kernel the model's views: B and C as
    column views of an x_proj-shaped (B, S, R + 2N) tensor (R = 8: rows
    16-byte aligned; R = 5: not), dt and x off 16-byte alignment (4-byte
    copies), a batch of one; no padding, y contiguous and equal to the
    oracle's."""
    B, S, DI, N = (1 if layout == "batch_of_one" else 2), 77, 40, 16
    c = mamba_case(23, B=B, S=S, DI=DI, N=N)
    dt, A, Bm, Cm, x, h0 = (t(c[k], cuda) for k in ("dt", "A", "B", "C", "x",
                                                    "h0"))
    if layout.startswith("x_proj"):
        R = 8 if layout == "x_proj" else 5
        xp = torch.ones(B, S, R + 2 * N, device=cuda)
        xp[..., R:R + N], xp[..., R + N:] = Bm, Cm
        _, Bm, Cm = xp.split([R, N, N], dim=-1)
    elif layout == "unaligned":
        dt, x = (torch.cat([torch.ones_like(a[..., :1]), a], -1)[..., 1:]
                 for a in (dt, x))
    args = (dt, A, Bm, Cm, x, h0)
    y, h = _launched(tms, "mamba_scan", lambda: tmsops.mamba_scan(*args))
    assert y.shape == (B, S, DI) and y.is_contiguous()
    wy, wh = tmsops.mamba_scan(*(a.cpu() for a in args))
    _scaled_close(y, wy, 1e-5)
    _scaled_close(h, wh, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,layout", [(16, "model"), (36, "model"),
                                       (120, "model"), (128, "model"),
                                       (32, "fused_qkv"), (64, "unaligned")])
def test_flash_op_reads_model_layout_on_card(cuda, hd, layout):
    """``ops.flash_attention`` on (B, S, H, hd) tensors: contiguous (the
    kernel reads transposed views and writes the output in the model's
    layout, so it comes back contiguous), q, k and v as slices of one
    fused (B, S, H + 2KV, hd) tensor, or rows off 16-byte alignment
    (copied first); head dims 16, 36 (not a multiple of 8), 120, 128."""
    B, S, H, KV = 2, 150, 4, 2
    c = flash_case(24, B=B, Sq=S, Sk=S, H=H, KV=KV, hd=hd, causal=True,
                   window=None)
    q, k, v = (t(c[n], cuda) for n in "qkv")
    if layout == "fused_qkv":
        q, k, v = torch.cat([q, k, v], dim=2).split([H, KV, KV], dim=2)
    elif layout == "unaligned":
        q, k, v = (torch.cat([torch.ones_like(a[..., :1]), a], -1)[..., 1:]
                   for a in (q, k, v))
    got = _launched(tfa, "flash_attention",
                    lambda: tfops.flash_attention(q, k, v, causal=True))
    assert got.shape == (B, S, H, hd)
    if layout == "model":
        assert got.is_contiguous()
    close(got, tfops.flash_attention(q.cpu(), k.cpu(), v.cpu(),
                                     causal=True).numpy())


#: (Sq, Sk, sk_valid, causal, window, q_offset): keys past sk_valid, a
#: window shorter than one tile, queries at the end of longer keys, a
#: non-causal window, and rows placed before every key (they give 0)
FLASH_EDGES = [(150, 150, 100, True, None, 0),
               (200, 200, 200, True, 5, 0),
               (40, 300, 300, True, None, 260),
               (60, 300, 250, True, 50, 130),
               (90, 90, 90, False, 7, 0),
               (20, 64, 64, True, None, -10)]


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,sk_valid,causal,window,q_offset",
                         FLASH_EDGES)
def test_flash_kernel_edges_match_plain_on_card(cuda, Sq, Sk, sk_valid,
                                                causal, window, q_offset):
    rng = np.random.RandomState(25)
    q = t(rng.randn(1, 4, Sq, 64).astype(np.float32), cuda)
    k, v = (t(rng.randn(1, 2, Sk, 64).astype(np.float32), cuda)
            for _ in range(2))
    k[:, :, sk_valid:] = 1e4                 # padding: never seen
    v[:, :, sk_valid:] = 1e4
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              sk_valid=sk_valid)
    got = _launched(tfa, "flash_attention",
                    lambda: tfa.flash_attention_fwd(q, k, v, **kw))
    plain = tfa.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(), **kw)
    assert torch.isfinite(got).all()
    close(got, plain.numpy())
    if q_offset < 0:
        assert not got.cpu()[:, :, :-q_offset].any()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,S,P", [("whisper-small", 133, 0),
                                      ("internvl2-26b", 125, 8)])
def test_encdec_and_vision_smoke_decode_on_card(cuda, arch, S, P):
    """The whisper smoke config (cross attention, MHA decode: one query
    head a CTA) and the InternVL2 one (a vision prefix that pushes the
    prompt across a block boundary): prefill, then 8 greedy decode steps
    whose tokens through the paged decode kernel equal ``page_impl="ref"``'s,
    with one kernel launch per layer per step."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tfm
    cfg = get_smoke(arch)
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=cuda).manual_seed(3),
        device=cuda, dtype=torch.float32)
    rng = np.random.RandomState(4)
    B, steps = 2, 8
    tokens = t(rng.randint(1, cfg.vocab, (B, S)).astype(np.int32), cuda)
    kw = {}
    if cfg.enc_dec:
        kw["enc_frames"] = t(rand(rng, B, cfg.enc_len, cfg.d_model), cuda)
    if P:
        kw["patches"] = t(rand(rng, B, P, cfg.d_model), cuda)
    toks = {}
    for page_impl in ("kernel", "ref"):
        st = tfm.init_decode_state(cfg, B, 384, device=cuda)
        lg, st = tfm.prefill(params, cfg, tokens, st, **kw)
        assert (st["lengths"] == P + S).all()
        tok = lg.argmax(-1).to(torch.int32)
        out = [tok]
        before = tpa.LAUNCHES["paged_decode"]
        for _ in range(steps):
            lg, st = tfm.decode_step(params, cfg, st, tok,
                                     page_impl=page_impl)
            assert torch.isfinite(lg).all()
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        assert tpa.LAUNCHES["paged_decode"] - before == (
            steps * cfg.n_layers if page_impl == "kernel" else 0)
        toks[page_impl] = torch.stack(out).cpu()
    assert torch.equal(toks["kernel"], toks["ref"])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 40])
def test_chunked_attention_backward_matches_direct_on_card(cuda, window,
                                                          monkeypatch):
    """The chunked attention's autograd Function (recompute from lse) on
    the card against autograd through the O(S²) oracle, with two query
    blocks (Q_BLOCK patched to 64) and a partial last KV chunk; TF32 off."""
    from repro_torch.models import attention as tattn
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(5)
    q, k, v, dout = (t(rand(rng, 2, 128, H, 64), cuda)
                     for H in (8, 2, 2, 8))
    grads = []
    monkeypatch.setattr(tattn, "Q_BLOCK", 64)
    for fn, kw in ((tattn.chunked_attention, {"chunk": 48}),
                   (tattn.direct_attention, {})):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, causal=True, window=window, **kw)
        grads.append([out.detach()] + list(torch.autograd.grad(
            out, leaves, dout)))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_train_step_runs_on_card(cuda):
    """One AdamW step of the granite smoke config on the card: a finite
    loss and grad norm, params that moved, stayed on the card and
    require no grad, and no kernel launched (the kernels are forward
    only)."""
    from repro_torch.bridge import leaves
    from repro_torch.configs import get_smoke
    from repro_torch.training import train_loop as ttl
    from repro_torch.training.data import DataConfig, SyntheticLM
    cfg = get_smoke("granite-3-8b")
    tc = ttl.TrainConfig()
    params, opt, err = ttl.init_all(
        torch.Generator(device=cuda).manual_seed(0), cfg, tc,
        dtype=torch.float32)
    before = [p.clone() for p in leaves(params)]
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=2))
    launches = dict(tpa.LAUNCHES)
    params, opt, err, m = ttl.make_train_step(cfg, tc)(
        params, opt, err, {k: t(v, cuda) for k, v in data.batch(0).items()})
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert dict(tpa.LAUNCHES) == launches
    assert all(p.is_cuda and not p.requires_grad for p in leaves(params))
    assert any(not torch.equal(a, b)
               for a, b in zip(leaves(params), before))


@pytest.mark.cuda
def test_autotune_records_a_depth_on_card(cuda):
    """The tuner times every depth (positive ms), records the fastest, and
    the decode output at that depth is bit-identical to depth 2's."""
    from repro_torch.kernels.paged_attention import autotune as ttune
    try:
        tuning = ttune.autotune(2, 16, 128, 4, batch=5, group=2, reps=5)
        assert tuning.buffer_depth in ttune.BUFFER_DEPTHS
        assert sorted(tuning.ms) == list(ttune.BUFFER_DEPTHS)
        assert all(ms > 0 for ms in tuning.ms.values())
        assert ttune.get_tuning(2, 16, 128) == tuning
        c = paged_case(11)
        args = (t(c["q"], cuda), t(c["kv"], cuda), t(c["stack"], cuda),
                t(c["lengths"], cuda))
        tuned = tops.paged_attention(*args, buffer_depth=tuning.buffer_depth)
        assert torch.equal(tuned, tops.paged_attention(*args, buffer_depth=2))
    finally:
        ttune.clear()


@pytest.mark.cuda
def test_autotune_records_a_bf16_depth_on_its_own_key_on_card(cuda):
    """``autotune(dtype=bfloat16)`` times a bf16 pool and records under
    the bf16 key; the f32 key keeps its default until tuned itself."""
    from repro_torch.kernels.paged_attention import autotune as ttune
    try:
        tuning = ttune.autotune(2, 16, 128, 4, batch=5, group=2, reps=5,
                                dtype=torch.bfloat16)
        assert sorted(tuning.ms) == list(ttune.BUFFER_DEPTHS)
        assert ttune.get_tuning(2, 16, 128, dtype=torch.bfloat16) == tuning
        assert ttune.get_tuning(2, 16, 128).ms is None
        assert ttune.tuning_key(2, 16, 128) != ttune.tuning_key(
            2, 16, 128, dtype=torch.bfloat16)
    finally:
        ttune.clear()


@pytest.mark.cuda
def test_sp_decode_on_two_gloo_ranks_on_card(cuda, tmp_path):
    """Two processes on one GPU over gloo (a (data 1, model 2) mesh of CUDA
    tensors): the SP decode, walking every table column and only the
    rank's own, equals the single-device kernel within 2e-5."""
    import json

    from _torch_dist_ranks import spawn
    from repro_torch.models.transformer import sp_identity_tables
    c = paged_case(12, B=4, M=4)
    B, M = c["mono"].shape
    N = c["kv"].shape[0] + 1                    # even: two pool shards
    kv = np.concatenate([c["kv"], c["kv"][:1]])
    ident = sp_identity_tables(B, M, N, 1, 2, device="cpu").numpy()
    case = {}
    for name, tables in (("sp", c["mono"]), ("sp_opt", ident)):
        args = (t(c["q"], cuda), t(kv, cuda), t(tables, cuda),
                t(c["lengths"], cuda))
        case[name] = {"q": args[0].cpu(), "kv": args[1].cpu(),
                      "tables": args[2].cpu(), "lengths": args[3].cpu(),
                      "want": tops.paged_attention(*args).cpu()}
    torch.save(case, tmp_path / "case.pt")
    for r, (code, log) in enumerate(spawn(tmp_path, 2, "cuda", timeout=180)):
        assert code == 0, log
        with open(tmp_path / f"result_{r}.json") as f:
            res = json.load(f)
        assert sorted(res) == ["cuda_sp/sp", "cuda_sp/sp_opt"]
        for name, out in res.items():
            assert out["ok"], f"rank {r}, {name}:\n{out['error']}"


@pytest.mark.cuda
def test_train_step_on_two_gloo_ranks_on_card(cuda, tmp_path):
    """The tiny tied decoder's mesh step on two processes sharing the card
    over gloo, on (data 2, model 1) and (data 1, model 2) meshes of CUDA
    tensors (FSDP; tensor parallel with the vocab-parallel loss), against
    the single-process step on the card: loss and grad norm within 1e-5
    relative, the first moments within 1e-5 of each leaf's max."""
    import pickle
    from _torch_dist_ranks import spawn
    from repro_torch.bridge import leaves, params_to_jax, tree_map
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ModelConfig
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_loop as ttl
    cfg = dict(name="tiny", n_layers=2, d_model=32, n_heads=4,
               n_kv_heads=2, d_ff=64, vocab=61, head_dim=16,
               tie_embeddings=True)
    mcfg = ModelConfig(**cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tfm.init_params(mcfg, generator=gen, device="cuda")
    rng = np.random.RandomState(1)
    toks = rng.randint(0, 61, (4, 32)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    labels[0, :7] = -100
    batch = {"tokens": toks, "labels": labels.astype(np.int32)}
    tc = dict(adamw=dict(lr=1e-3, warmup_steps=1))
    host = params_to_jax(params)
    cases = {"device": "cuda"}
    for shape in ((2, 1), (1, 2)):
        cases[f"step-{shape[0]}x{shape[1]}"] = dict(
            kind="step", cfg=cfg, params=host, batches=[batch], tc=tc,
            mesh=shape)
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    step = ttl.make_train_step(mcfg, ttl.TrainConfig(
        adamw=topt.AdamWConfig(lr=1e-3, warmup_steps=1)), donate=False)
    p = tree_map(torch.clone, params)
    _, opt, _, want = step(p, topt.init_opt_state(p), torch.zeros(
        (), device="cuda"), {k: torch.as_tensor(v, device="cuda")
                             for k, v in batch.items()})
    mu = [np.asarray(x) for x in leaves(params_to_jax(opt["mu"]))]
    script = str(Path(__file__).with_name("_torch_train_ranks.py"))
    logs = spawn(tmp_path, 2, script=script, timeout=240)
    assert [code for code, _ in logs] == [0, 0], "\n".join(
        f"rank {r} exited {code}:\n{log[-3000:]}"
        for r, (code, log) in enumerate(logs))
    with open(tmp_path / "result_0.pkl", "rb") as f:
        res = pickle.load(f)
    for name, out in res.items():
        assert out["ok"], out["error"]
        got = out["value"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k][0], want[k].item(), rtol=1e-5,
                                       err_msg=name)
        for g, w in zip(leaves(got["mu"]), mu):
            assert np.abs(np.asarray(g) - w).max() <= 1e-5 * max(
                np.abs(w).max(), 1e-30), name
