"""Per-function parity of the port against the JAX reference: layers,
attention, the paged-attention plain versions, the kernel wrappers (CPU
path vs the Pallas kernel in interpret mode and vs the JAX oracle), the
ops entry points, the descriptor builder and the tuning cache.  Inputs
come from a NumPy seed and go through both packages; f32 throughout,
atol = rtol = 2e-5 (the two sides sum in other orders)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro.kernels.paged_attention import ref as jref  # noqa: E402
from repro.kernels.paged_attention import autotune as jtune  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.config import AttnConfig as JAttn  # noqa: E402
from repro.models.config import ModelConfig as JCfg  # noqa: E402
from repro_torch.kernels.paged_attention import autotune as ttune  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as tpa  # noqa: E402
from repro_torch.kernels.paged_attention import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.config import AttnConfig as TAttn  # noqa: E402
from repro_torch.models.config import ModelConfig as TCfg  # noqa: E402
from _torch_cases import (PAGED, RAGGED, paged_case, ragged_case,  # noqa: E402
                          rand, tables)

TOL = dict(rtol=2e-5, atol=2e-5)
#: matmul outputs of unit-normal inputs reach |x| ~ 250 (f32 ulp ~ 3e-5
#: there) and rope angles reach 5e3 rad, where the two libraries' sin/cos
#: differ by ulps; an element that cancels to ~1 keeps that absolute error
MATMUL_TOL = dict(rtol=2e-5, atol=1e-4)


def t(a, device="cpu"):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **(tol or TOL))


# ----------------------------------------------------------------- layers
def test_layers_match_reference():
    rng = np.random.RandomState(0)
    x, s = rand(rng, 3, 5, 32), rand(rng, 32)
    close(tlayers.rms_norm(t(x), t(s), 1e-5), jlayers.rms_norm(x, s, 1e-5))
    close(tlayers.rope_freqs(16, 10_000.0), jlayers.rope_freqs(16, 10_000.0))
    xr = rand(rng, 2, 7, 3, 16)
    pos = rng.randint(0, 5000, (2, 7)).astype(np.int32)
    close(tlayers.apply_rope(t(xr), t(pos), 500_000.0),
          jlayers.apply_rope(xr, pos, 500_000.0), **MATMUL_TOL)
    p = {"w_gate": rand(rng, 32, 48), "w_up": rand(rng, 32, 48),
         "w_down": rand(rng, 48, 32), "norm": rand(rng, 32)}
    close(tlayers.swiglu(t(x), t(p["w_gate"]), t(p["w_up"]),
                         t(p["w_down"])),
          jlayers.swiglu(x, p["w_gate"], p["w_up"], p["w_down"]),
          **MATMUL_TOL)
    close(tlayers.dense_ffn({k: t(v) for k, v in p.items()}, t(x), 1e-5),
          jlayers.dense_ffn(p, x, 1e-5), **MATMUL_TOL)
    table = rand(rng, 64, 32)
    toks = rng.randint(0, 64, (3, 4)).astype(np.int32)
    close(tlayers.embed(t(toks), t(table)), jlayers.embed(toks, table))
    close(tlayers.unembed(t(x), t(table)), jlayers.unembed(x, table))


def test_initializers_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    w = tlayers.init_dense(256, 64, generator=g, device="cpu",
                           dtype=torch.float32)
    assert w.shape == (256, 64) and abs(w.std().item() - 1 / 16) < 5e-3
    e = tlayers.init_embed(100, 32, generator=g, device="cpu",
                           dtype=torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(e.float().std() - 0.02) < 3e-3
    sw = tlayers.init_swiglu(32, 48, generator=g, device="cpu")
    assert {k: tuple(v.shape) for k, v in sw.items()} == {
        "w_gate": (32, 48), "w_up": (32, 48), "w_down": (48, 32)}


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_qkv_proj_matches_reference(qkv_bias):
    kw = dict(name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab=64, head_dim=8)
    jcfg = JCfg(**kw, attn=JAttn(qkv_bias=qkv_bias))
    tcfg = TCfg(**kw, attn=TAttn(qkv_bias=qkv_bias))
    rng = np.random.RandomState(1)
    p = {"wq": rand(rng, 32, 32), "wk": rand(rng, 32, 16),
         "wv": rand(rng, 32, 16), "bq": rand(rng, 32), "bk": rand(rng, 16),
         "bv": rand(rng, 16)}
    x = rand(rng, 2, 5, 32)
    pos = np.broadcast_to(np.arange(3, 8), (2, 5)).astype(np.int32)
    got = tattn.qkv_proj({k: t(v) for k, v in p.items()}, t(x), tcfg, t(pos))
    want = jattn.qkv_proj(p, x, jcfg, pos)
    for g, w in zip(got, want):
        close(g, w, **MATMUL_TOL)
    init = tattn.init_attn(tcfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    want = {"norm", "wq", "wk", "wv", "wo"}
    assert set(init) == (want | {"bq", "bk", "bv"} if qkv_bias else want)


@pytest.mark.parametrize("Sq,Sk,window,q_offset,chunk", [
    (16, 16, None, 0, 8), (8, 40, None, 32, 16), (24, 24, 5, 0, 16),
    (8, 300, 64, 256, 128)])
def test_attention_matches_reference(Sq, Sk, window, q_offset, chunk):
    rng = np.random.RandomState(2)
    q, k, v = rand(rng, 2, Sq, 4, 8), rand(rng, 2, Sk, 2, 8), \
        rand(rng, 2, Sk, 2, 8)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    close(tattn.direct_attention(t(q), t(k), t(v), **kw),
          jattn.direct_attention(q, k, v, **kw))
    close(tattn.chunked_attention_fwd(t(q), t(k), t(v), chunk=chunk, **kw),
          jattn.chunked_attention_fwd(q, k, v, chunk=chunk, **kw))
    close(tattn.chunked_attention(t(q), t(k), t(v), chunk=chunk, **kw),
          jattn.chunked_attention(q, k, v, chunk=chunk, **kw))


@pytest.mark.parametrize("W", [1, 2, 4])
def test_table_helpers_match_reference(W):
    rng = np.random.RandomState(3)
    mono, stack = tables(rng, 5, 3, 40, W)
    np.testing.assert_array_equal(
        tattn.assemble_shard_tables(t(stack))[:5],
        jattn.assemble_shard_tables(jnp.asarray(stack))[:5])
    slots = rng.randint(0, 5, 7).astype(np.int32)
    blk = rng.randint(0, 3, 7).astype(np.int32)
    np.testing.assert_array_equal(
        tattn.lookup_slot_blocks(t(stack), t(slots).long(), t(blk).long()),
        jattn.lookup_slot_blocks(jnp.asarray(stack), slots, blk))
    np.testing.assert_array_equal(
        tattn.lookup_slot_blocks(t(mono), t(slots).long(), t(blk).long()),
        mono[slots, blk])
    k, v = rand(rng, 3, 4, 2, 8), rand(rng, 3, 4, 2, 8)
    fused = tattn.fuse_kv(t(k), t(v))
    np.testing.assert_array_equal(fused, jattn.fuse_kv(k, v))
    ks, vs = tattn.split_fused_kv(fused)
    np.testing.assert_array_equal(ks, k)
    np.testing.assert_array_equal(vs, v)


@pytest.mark.parametrize("case", PAGED, ids=str)
def test_paged_plain_versions_match_reference(case):
    c = paged_case(4, **case)
    w = c["window"]
    kp, vp = c["kv"][:, :, 0::2], c["kv"][:, :, 1::2]
    want = jattn.paged_decode_attention_ref(c["q"], kp, vp, c["mono"],
                                            c["lengths"], window=w)
    close(tattn.paged_decode_attention_ref(
        t(c["q"]), t(kp), t(vp), t(c["mono"]), t(c["lengths"]), window=w),
        want)
    close(tref.paged_decode_attention_sharded_ref(
        t(c["q"]), t(kp), t(vp), t(c["stack"]), t(c["lengths"]), window=w),
        jref.paged_decode_attention_sharded_ref(
            c["q"], kp, vp, jnp.asarray(c["stack"]), c["lengths"], window=w))
    close(tref.paged_decode_attention_fused_ref(
        t(c["q"]), t(c["kv"]), t(c["stack"]), t(c["lengths"]), window=w),
        jref.paged_decode_attention_fused_ref(
            c["q"], c["kv"], jnp.asarray(c["stack"]), c["lengths"],
            window=w))


@pytest.mark.parametrize("case", PAGED, ids=str)
def test_decode_wrappers_match_pallas_and_oracle(case):
    """CPU path of the decode wrappers (fused at depths 1/2/4, split)
    against the Pallas kernel in interpret mode and the JAX oracle."""
    c = paged_case(5, **case)
    w = c["window"]
    oracle = jref.paged_decode_attention_fused_ref(
        c["q"], c["kv"], jnp.asarray(c["stack"]), c["lengths"], window=w)
    pallas = jops.paged_attention(c["q"], c["kv"], jnp.asarray(c["stack"]),
                                  c["lengths"], window=w, buffer_depth=2,
                                  interpret=True)
    for depth in (1, 2, 4):
        got = tops.paged_attention(t(c["q"]), t(c["kv"]), t(c["stack"]),
                                   t(c["lengths"]), window=w,
                                   buffer_depth=depth)
        close(got, oracle)
        close(got, pallas)
    kp = np.ascontiguousarray(c["kv"][:, :, 0::2])
    vp = np.ascontiguousarray(c["kv"][:, :, 1::2])
    got = tops.paged_attention_split(t(c["q"]), t(kp), t(vp), t(c["stack"]),
                                     t(c["lengths"]), window=w)
    close(got, oracle)
    close(got, jops.paged_attention_split(
        c["q"], kp, vp, jnp.asarray(c["stack"]), c["lengths"], window=w,
        interpret=True))


@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_ragged_plain_version_matches_reference(case):
    c = ragged_case(6, **case)
    d = c["d"]
    args = [d[k] for k in ("token_row", "token_pos", "kv_lens")]
    want = jref.ragged_fused_ref(c["q"], c["kv"], jnp.asarray(c["stack"]),
                                 *args, window=c["window"])
    got = tref.ragged_fused_ref(t(c["q"]), t(c["kv"]), t(c["stack"]),
                                *map(t, args), window=c["window"])
    close(got, want)


@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_ragged_wrapper_matches_pallas_and_oracle(case):
    """Real rows only: padding rows are finite garbage in the kernels."""
    c = ragged_case(7, **case)
    d, w = c["d"], c["window"]
    real = d["token_row"] >= 0
    got = tops.ragged_paged_attention(
        t(c["q"]), t(c["kv"]), t(c["stack"]), t(d["tile_row"]),
        t(d["tile_pos"]), t(d["kv_lens"]), window=w)
    pallas = jops.ragged_paged_attention(
        c["q"], c["kv"], jnp.asarray(c["stack"]), d["tile_row"],
        d["tile_pos"], d["kv_lens"], window=w, interpret=True)
    oracle = jref.ragged_fused_ref(c["q"], c["kv"], jnp.asarray(c["stack"]),
                                   d["token_row"], d["token_pos"],
                                   d["kv_lens"], window=w)
    close(got[t(real)], np.asarray(pallas)[real])
    close(got[t(real)], np.asarray(oracle)[real])


def test_wrappers_reject_what_the_kernel_does_not_take():
    c = paged_case(8)
    q = t(c["q"]).reshape(5, 2, 2, 16)
    with pytest.raises(ValueError):
        tpa.paged_attention_fused_fwd(q, t(c["kv"]), t(c["stack"]),
                                      t(c["lengths"]), buffer_depth=3)
    with pytest.raises(ValueError):           # pool heads != 2 * KV
        tpa.paged_attention_fused_fwd(q, t(c["kv"])[:, :, :2],
                                      t(c["stack"]), t(c["lengths"]))
    with pytest.raises(ValueError):           # T not a multiple of QT
        tpa.ragged_fused_fwd(t(np.zeros((9, 2, 2, 16), np.float32)),
                             t(c["kv"]), t(c["stack"]),
                             t(np.zeros(1, np.int32)),
                             t(np.zeros(1, np.int32)),
                             t(np.ones(5, np.int32)))


# -------------------------------------------------- descriptor and tuning
@pytest.mark.parametrize("seed", range(4))
def test_ragged_descriptor_is_the_reference_algorithm(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 6)
    slots = rng.permutation(8)[:n]
    qn = rng.randint(0, 40, n)
    start = rng.randint(0, 500, n)
    kv = start + qn
    got = tops.build_ragged_descriptor(slots, qn, start, kv, num_slots=8,
                                       t_cap=256)
    want = jops.build_ragged_descriptor(slots, qn, start, kv, num_slots=8,
                                        t_cap=256)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tops.QT == jops.QT == tpa.QT


def test_table_index_matches_reference():
    from repro.kernels.paged_attention.paged_attention import _table_index
    for W, Bs, M in ((1, 5, 3), (2, 3, 4), (4, 2, 6)):
        for b in range(W * Bs):
            for m in range(M):
                assert tpa._table_index(b, m, W=W, Bs=Bs, M=M) == \
                    _table_index(b, m, W=W, Bs=Bs, M=M)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_shard_descriptor_matches_reference(W):
    _, stack = tables(np.random.RandomState(9), 5, 3, 40, W)
    got = tops.shard_descriptor(t(stack))
    want = jops.shard_descriptor(jnp.asarray(stack))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    mono = stack[0]
    got = tops.shard_descriptor(t(mono))
    np.testing.assert_array_equal(got[0], jops.shard_descriptor(
        jnp.asarray(mono))[0])


def test_tuning_cache_defaults_match_reference():
    assert ttune.DEFAULT_BUFFER_DEPTH == jtune.DEFAULT_BUFFER_DEPTH
    assert ttune.BUFFER_DEPTHS == jtune.BUFFER_DEPTHS
    assert ttune.get_tuning(2, 16, 128) == ttune.KernelTuning(128, 2)
    ttune.set_tuning(2, 16, 128, ttune.KernelTuning(128, 4))
    try:
        assert ttune.get_tuning(2, 16, 128).buffer_depth == 4
        with pytest.raises(ValueError):
            ttune.set_tuning(2, 16, 128, ttune.KernelTuning(128, 3))
    finally:
        ttune.clear()
    assert ttune.get_tuning(2, 16, 128).buffer_depth == 2


def test_autotune_refuses_the_cpu():
    """The tuner times the CUDA kernel with CUDA events: no modelled
    fallback on the CPU, and nothing recorded."""
    with pytest.raises(RuntimeError, match="CUDA events"):
        ttune.autotune(2, 16, 128, 4, batch=2, group=2, device="cpu")
    assert ttune.get_tuning(2, 16, 128).ms is None


def test_decode_reads_the_recorded_depth(monkeypatch):
    """``_paged_attn(page_impl="kernel")`` passes the depth recorded for
    its (KV heads, head_dim, bs) to the kernel, and the default after
    ``clear()``."""
    from repro_torch.models import transformer as ttfm
    c = paged_case(3)
    seen = []
    real = tops.paged_attention

    def spy(*a, buffer_depth, **k):
        seen.append(buffer_depth)
        return real(*a, buffer_depth=buffer_depth, **k)
    monkeypatch.setattr(tops, "paged_attention", spy)
    args = (t(c["q"]), t(c["kv"]), t(c["mono"]), t(c["lengths"]))
    ttune.set_tuning(2, 16, 128, ttune.KernelTuning(128, 4))
    try:
        tuned = ttfm._paged_attn(*args, page_impl="kernel", window=None)
    finally:
        ttune.clear()
    default = ttfm._paged_attn(*args, page_impl="kernel", window=None)
    assert seen == [4, ttune.DEFAULT_BUFFER_DEPTH]
    assert torch.equal(tuned, default)
