"""Parity of the port's Mamba slice against the JAX reference on the CPU:
the selective scan's plain version and its kernel wrapper against the
Pallas kernel in interpret mode (the reference's own kernel-test cases
and tolerance, 1e-5), ``mamba_mix`` for every impl with states carried
in, and ``mamba_decode_step`` over a few tokens (2e-5: the two sides sum
in other orders).  Parameters are made on the reference side and
bridged; inputs come from a NumPy seed."""

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

from repro.configs import jamba_v0_1_52b as jjamba  # noqa: E402
from repro.kernels.mamba_scan import ops as jms  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.configs import jamba_v0_1_52b as tjamba  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan as tmk  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as tms  # noqa: E402
from repro_torch.kernels.mamba_scan import ref as tref  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from _torch_cases import MAMBA, mamba_case, rand  # noqa: E402

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-5, atol=2e-5)
#: jax impl of each port impl
IMPL = {"chunked": "chunked", "sequential": "sequential",
        "kernel": "pallas_interpret"}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("case", MAMBA, ids=str)
def test_mamba_scan_matches_pallas_interpret(case):
    c = mamba_case(1, **case)
    args = [c[k] for k in ("dt", "A", "B", "C", "x", "h0")]
    wy, wh = jms.mamba_scan(*map(jnp.asarray, args), chunk=c["chunk"],
                            interpret=True)
    py, ph = tref.mamba_scan_ref(*map(t, args))
    close(py, wy, **SCAN_TOL)
    close(ph, wh, **SCAN_TOL)
    # the op hands the wrapper the unpadded sequence, and the wrapper runs
    # the plain version on the CPU
    gy, gh = tms.mamba_scan(*map(t, args), chunk=c["chunk"])
    np.testing.assert_array_equal(gy.numpy(), py.numpy())
    np.testing.assert_array_equal(gh.numpy(), ph.numpy())


@pytest.fixture(scope="module")
def mixer():
    jcfg, tcfg = jjamba.smoke(), tjamba.smoke()
    jp = jmamba.init_mamba(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = {k: t(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("impl", sorted(IMPL))
def test_mamba_mix_matches_reference(mixer, impl, carried):
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.RandomState(4 + carried)
    B, S, DI, N = 2, 77, tcfg.d_inner, tcfg.mamba.d_state
    u = rand(rng, B, S, tcfg.d_model)
    states = dict(conv_state=rand(rng, B, tcfg.mamba.d_conv - 1, DI),
                  ssm_state=rand(rng, B, DI, N)) if carried else {}
    wy, (wc, ws) = jmamba.mamba_mix(
        jp, jnp.asarray(u), jcfg, impl=IMPL[impl],
        **{k: jnp.asarray(v) for k, v in states.items()})
    gy, (gc, gs) = tmamba.mamba_mix(
        tp, t(u), tcfg, impl=impl, **{k: t(v) for k, v in states.items()})
    close(gy, wy)
    close(gc, wc)
    close(gs, ws)


def test_mamba_chunked_scan_is_the_sequential_recurrence(mixer):
    """The doubling scan within chunks, across several chunks and a
    ragged tail, against the step-by-step recurrence."""
    _, tcfg, _, tp = mixer
    rng = np.random.RandomState(6)
    u = t(rand(rng, 1, 150, tcfg.d_model))
    ys, (_, hs) = tmamba.mamba_mix(tp, u, tcfg, impl="sequential")
    for chunk in (1, 16, 64):
        yc, (_, hc) = tmamba.mamba_mix(tp, u, tcfg, chunk=chunk)
        close(yc, ys.numpy())
        close(hc, hs.numpy())


def test_mamba_decode_step_matches_reference(mixer):
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.RandomState(7)
    B, DI = 3, tcfg.d_inner
    jcs = tcs = rand(rng, B, tcfg.mamba.d_conv - 1, DI)
    jss = tss = rand(rng, B, DI, tcfg.mamba.d_state)
    jcs, jss = jnp.asarray(jcs), jnp.asarray(jss)
    tcs, tss = t(tcs), t(tss)
    for step in range(4):
        x = rand(rng, B, tcfg.d_model)
        wy, (jcs, jss) = jmamba.mamba_decode_step(jp, jnp.asarray(x), jcfg,
                                                  jcs, jss)
        gy, (tcs, tss) = tmamba.mamba_decode_step(tp, t(x), tcfg, tcs, tss)
        close(gy, wy)
        close(tcs, jcs)
        close(tss, jss)


def test_mamba_scan_is_forward_only():
    c = mamba_case(8, B=1, S=5, DI=4, N=2)
    args = [t(c[k]) for k in ("dt", "A", "B", "C", "x", "h0")]
    args[4].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tmk.mamba_scan_fwd(*args)
    with torch.no_grad():
        y, _ = tmk.mamba_scan_fwd(*args)
    assert y.shape == (1, 5, 4)


def _x_proj_views(c, R):
    """B and C of a case as column views of an x_proj-shaped (B, S, R + 2N)
    tensor (the model's layout), with ones in the dt_rank columns."""
    Bsz, S, N = c["B"].shape
    xp = torch.ones(Bsz, S, R + 2 * N)
    xp[..., R:R + N], xp[..., R + N:] = t(c["B"]), t(c["C"])
    _, Bv, Cv = xp.split([R, N, N], dim=-1)
    return Bv, Cv


@pytest.mark.parametrize("R", [8, 5])
def test_mamba_op_on_x_proj_views_matches_pallas_interpret(R):
    """B and C as column views of the x_proj output (R = 8: rows 16-byte
    aligned; R = 5: not), S a multiple of no chunk: the op equals the
    reference's op in interpret mode."""
    c = mamba_case(9, B=2, S=45, DI=24, N=8)
    Bv, Cv = _x_proj_views(c, R)
    assert not Bv.is_contiguous()
    keys = ("dt", "A", "B", "C", "x", "h0")
    wy, wh = jms.mamba_scan(*(jnp.asarray(c[k]) for k in keys),
                            interpret=True)
    gy, gh = tms.mamba_scan(t(c["dt"]), t(c["A"]), Bv, Cv, t(c["x"]),
                            t(c["h0"]))
    close(gy, wy, **SCAN_TOL)
    close(gh, wh, **SCAN_TOL)


def test_mamba_op_hands_the_kernel_views_unpadded(monkeypatch):
    """``ops.mamba_scan`` passes the wrapper the model's tensors as they
    are: the unpadded S, and B and C as the same column views (no copy)."""
    seen = {}

    def record(*args):
        seen["args"] = args
        return tref.mamba_scan_ref(*args)
    monkeypatch.setattr(tms, "mamba_scan_fwd", record)
    c = mamba_case(10, B=2, S=45, DI=24, N=8)
    Bv, Cv = _x_proj_views(c, 8)
    dt, x = t(c["dt"]), t(c["x"])
    y, _ = tms.mamba_scan(dt, t(c["A"]), Bv, Cv, x, t(c["h0"]), chunk=16)
    got = seen["args"]
    assert y.shape == (2, 45, 24)
    assert got[0] is dt and got[2] is Bv and got[3] is Cv and got[4] is x


def test_mamba_wrapper_reads_strides_in_place():
    """The (batch, token) strides the kernel is given, and which rows take
    16-byte copies: x_proj views at R = 8 do, at R = 5 they do not; a
    tensor whose last stride is not 1 has none (it is copied)."""
    c = mamba_case(11, B=2, S=6, DI=8, N=16)
    Bv, _ = _x_proj_views(c, 8)
    st = tmk._strides(Bv)
    assert st == (6 * 40, 40) and tmk._aligned16(Bv, st)
    Bu, _ = _x_proj_views(c, 5)
    assert not tmk._aligned16(Bu, tmk._strides(Bu))
    assert tmk._strides(t(c["dt"])[:1]) == (0, 8)
    assert tmk._strides(t(c["dt"]).transpose(1, 2)) is None


def test_mamba_kernel_geometry_matches_the_source():
    src = tmk.SOURCE.read_text()
    for name, value in (("CH", tmk.CHANNELS_PER_BLOCK),
                        ("TC", tmk.STEPS_PER_STAGE),
                        ("STAGES", tmk.RING_STAGES)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(
            1) == str(value)
    cases = re.findall(r"case (\d+): return launch<", src)
    assert tuple(map(int, cases)) == tmk._STATES
