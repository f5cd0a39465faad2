"""Parity of the port's flash attention against the JAX reference on the
CPU: the plain version and the kernel wrapper's CPU path against the
Pallas kernel in interpret mode (the reference's own kernel-test cases
and tolerance, 2e-5, plus danube's head_dim 120 with a window), and
``attn_layer`` for every impl against its JAX twin."""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.configs import h2o_danube_3_4b as jdanube  # noqa: E402
from repro.configs import jamba_v0_1_52b as jjamba  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import h2o_danube_3_4b as tdanube  # noqa: E402
from repro_torch.configs import jamba_v0_1_52b as tjamba  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tfk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from _torch_cases import FLASH, flash_case, rand  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
#: jax impl of each port impl
IMPL = {"direct": "direct", "chunked": "chunked",
        "kernel": "pallas_interpret"}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_attention_matches_pallas_interpret(case):
    c = flash_case(1, **case)
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_offset"])
    qkv = [c[k] for k in ("q", "k", "v")]
    want = jfa.flash_attention(*map(jnp.asarray, qkv), interpret=True, **kw)
    close(tref.flash_attention_ref(*map(t, qkv), **kw), want)
    close(tfa.flash_attention(*map(t, qkv), **kw), want)


def test_flash_fwd_pads_and_sees_no_padded_key():
    """Padded keys past ``sk_valid`` hold garbage and stay unseen; a row
    that sees no key gives 0."""
    c = flash_case(2, B=1, Sq=8, Sk=8, H=2, KV=1, hd=16, causal=True,
                   window=None)
    q, k, v = (t(c[n]).transpose(1, 2) for n in "qkv")
    junk = torch.full((1, 1, 5, 16), 1e4)
    got = tfk.flash_attention_fwd(q, torch.cat([k, junk], 2),
                                  torch.cat([v, junk], 2), sk_valid=8)
    close(got, tfk.flash_attention_fwd(q, k, v).numpy())
    blind = tfk.flash_attention_fwd(q, k, v, q_offset=-3)
    assert not blind[:, :, :3].any() and blind[:, :, 3:].abs().sum() > 0


@pytest.mark.parametrize("impl", sorted(IMPL))
@pytest.mark.parametrize("model", ["jamba", "danube"])
def test_attn_layer_matches_reference(model, impl):
    """Jamba's attention layer (no rope) and danube's (rope, window 32)."""
    jcfg, tcfg = {"jamba": (jjamba.smoke(), tjamba.smoke()),
                  "danube": (jdanube.smoke(), tdanube.smoke())}[model]
    jp = jattn.init_attn(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = {k: t(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.RandomState(6)
    B, S = 2, 90
    x = rand(rng, B, S, tcfg.d_model)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = jattn.attn_layer(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                            impl=IMPL[impl])
    got = tattn.attn_layer(tp, t(x), t(pos), tcfg, impl=impl)
    close(got, want)


def test_flash_attention_is_forward_only():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        tfk.flash_attention_fwd(q, q, q)
    with torch.no_grad():
        assert tfk.flash_attention_fwd(q, q, q).shape == (1, 2, 8, 16)


def test_flash_op_on_fused_qkv_views_matches_pallas_interpret():
    """q, k and v as head slices of one fused (B, S, H + 2KV, hd) tensor
    (strided views, no copy), causal with the queries at the end of the
    keys: the op equals the reference's op in interpret mode."""
    c = flash_case(3, B=2, Sq=50, Sk=50, H=4, KV=2, hd=16, causal=True,
                   window=None)
    qkv = torch.cat([t(c["q"]), t(c["k"]), t(c["v"])], dim=2)
    q, k, v = qkv.split([4, 2, 2], dim=2)
    assert not q.is_contiguous()
    want = jfa.flash_attention(*(jnp.asarray(c[n]) for n in "qkv"),
                               causal=True, interpret=True)
    close(tfa.flash_attention(q, k, v, causal=True), want)


def test_flash_op_hands_the_kernel_transposed_views(monkeypatch):
    """``ops.flash_attention`` passes the wrapper heads-major views of the
    model's (B, S, H, hd) tensors (the same storage, unpadded lengths) and
    returns the output as a (B, S, H, hd) view of the wrapper's."""
    seen = {}

    def record(q, k, v, **kw):
        seen.update(q=q, k=k, v=v, kw=kw)
        return tfk.flash_attention_fwd(q, k, v, **kw)
    monkeypatch.setattr(tfa, "flash_attention_fwd", record)
    c = flash_case(4, B=1, Sq=37, Sk=37, H=4, KV=2, hd=16, causal=True,
                   window=None)
    q, k, v = (t(c[n]) for n in "qkv")
    o = tfa.flash_attention(q, k, v, causal=True, window=9)
    assert seen["q"].shape == (1, 4, 37, 16)
    for got, base in ((seen["q"], q), (seen["k"], k), (seen["v"], v)):
        assert got.data_ptr() == base.data_ptr()
        assert torch.equal(got, base.transpose(1, 2))
    assert seen["kw"] == dict(causal=True, window=9, q_offset=0)
    assert o.shape == (1, 37, 4, 16)


def test_flash_wrapper_reads_strides_in_place():
    """The (batch, head, row) strides the kernel is given: a transposed view
    of a (B, S, H, hd) tensor is read in place; rows off 16-byte alignment
    or a last stride other than 1 take an aligned contiguous copy."""
    x = torch.zeros(2, 10, 4, 16)
    view = x.transpose(1, 2)
    assert tfk._strides(view) == (640, 16, 64)
    assert tfk._readable(view) is view
    off = torch.zeros(2 * 4 * 10 * 16 + 1)[1:].view(2, 4, 10, 16)
    assert tfk._strides(off) is None
    copy = tfk._readable(off)
    assert copy.is_contiguous() and tfk._strides(copy) is not None
    assert tfk._strides(x.permute(0, 2, 3, 1)) is None


def test_flash_kernel_geometry_matches_the_source():
    src = tfk.SOURCE.read_text()
    assert re.search(r"constexpr int NW = (\d+);", src).group(1) == str(
        tfk.BLOCK_Q // 16)
    for name, value in (("BK", tfk.BLOCK_K),
                        ("STAGES", tfk.RING_STAGES),
                        ("MAX_HD", tfk._MAX_HD)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(
            1) == str(value)
    # every head width the wrapper takes has an instantiation
    inst = [int(w) for w in re.findall(r"return launch<(\d+)>", src)]
    assert inst == sorted(inst) and inst[-1] == tfk._MAX_HD
