"""Parity of the port's RWKV-6 slice against the JAX reference on the
CPU: the WKV scan's plain version and its kernel wrapper against the
Pallas kernel in interpret mode (the reference's own kernel-test cases
and tolerance, 2e-4), ``rwkv6_mix`` for every impl with states carried
in, and ``rwkv6_decode_step`` over a few tokens (2e-5: the two sides sum
in other orders).  Parameters are made on the reference side and
bridged; inputs come from a NumPy seed."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.configs import rwkv6_7b as jrwkv  # noqa: E402
from repro.kernels.rwkv6_scan import ops as jrk  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro_torch.configs import rwkv6_7b as trwkv  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as trk  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as tref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as tkk  # noqa: E402
from repro_torch.models import rwkv6 as trwkv6  # noqa: E402
from _torch_cases import RWKV6, rand, rwkv6_case  # noqa: E402

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=2e-5, atol=2e-5)
#: jax impl of each port impl
IMPL = {"chunked": "chunked", "sequential": "sequential",
        "kernel": "pallas_interpret"}
HS = trwkv6.HEAD_SIZE


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("case", RWKV6, ids=str)
def test_rwkv6_scan_matches_pallas_interpret(case):
    c = rwkv6_case(1, **case)
    args = [c[k] for k in ("r", "k", "v", "w", "u", "S0")]
    wy, ws = jrk.rwkv6_scan(*map(jnp.asarray, args), chunk=c["chunk"],
                            interpret=True)
    py, ps = tref.rwkv6_scan_ref(*map(t, args))
    close(py, wy, **SCAN_TOL)
    close(ps, ws, **SCAN_TOL)
    # the wrapper pads with w = 1, r = k = v = 0 and runs the plain version
    # on the CPU: the padding leaves the state exactly as it was
    gy, gs = trk.rwkv6_scan(*map(t, args), chunk=c["chunk"])
    np.testing.assert_array_equal(gy.numpy(), py.numpy())
    np.testing.assert_array_equal(gs.numpy(), ps.numpy())


@pytest.fixture(scope="module")
def mixer():
    jcfg, tcfg = jrwkv.smoke(), trwkv.smoke()
    jp = jrwkv6.init_rwkv6(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = {k: t(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("impl", sorted(IMPL))
def test_rwkv6_mix_matches_reference(mixer, impl, carried):
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.RandomState(4 + carried)
    B, S, D = 2, 45, tcfg.d_model
    u = rand(rng, B, S, D)
    states = dict(x_prev=rand(rng, B, D),
                  wkv_state=(0.1 * rand(rng, B, D // HS, HS, HS)).astype(
                      np.float32)) if carried else {}
    wy, (wx, ws) = jrwkv6.rwkv6_mix(
        jp, jnp.asarray(u), jcfg, impl=IMPL[impl],
        **{k: jnp.asarray(v) for k, v in states.items()})
    gy, (gx, gs) = trwkv6.rwkv6_mix(
        tp, t(u), tcfg, impl=impl, **{k: t(v) for k, v in states.items()})
    close(gy, wy)
    close(gx, wx)
    close(gs, ws)


def test_rwkv6_decay_rounds_through_bf16(mixer):
    """The decay goes through bf16 before the scan, in both frameworks:
    the projections' w, rounded, gives the same state as the reference."""
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.RandomState(9)
    u = rand(rng, 1, 3, tcfg.d_model)
    x_prev = np.concatenate([np.zeros((1, 1, tcfg.d_model), np.float32),
                             u[:, :-1]], axis=1)
    *_, w = trwkv6._projections(tp, t(u), t(x_prev), tcfg)
    *_, jw = jrwkv6._projections(jp, jnp.asarray(u), jnp.asarray(x_prev),
                                 jcfg)
    np.testing.assert_array_equal(
        w.to(torch.bfloat16).float().numpy(),
        np.asarray(jw.astype(jnp.bfloat16).astype(jnp.float32)))


def test_rwkv6_decode_step_matches_reference(mixer):
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.RandomState(7)
    B, D = 3, tcfg.d_model
    lx = rand(rng, B, D)
    st = (0.1 * rand(rng, B, D // HS, HS, HS)).astype(np.float32)
    jlx, jst, tlx, tst = jnp.asarray(lx), jnp.asarray(st), t(lx), t(st)
    for step in range(4):
        x = rand(rng, B, D)
        wy, (jlx, jst) = jrwkv6.rwkv6_decode_step(jp, jnp.asarray(x), jcfg,
                                                  jlx, jst)
        gy, (tlx, tst) = trwkv6.rwkv6_decode_step(tp, t(x), tcfg, tlx, tst)
        close(gy, wy)
        close(tlx, jlx)
        close(tst, jst)


def test_rwkv6_scan_is_forward_only():
    c = rwkv6_case(8, B=1, S=4, nH=1, hd=16)
    r, k, v, w = (t(c[n]).transpose(1, 2).contiguous() for n in "rkvw")
    args = (r.requires_grad_(True), k, v, w, t(c["u"]), t(c["S0"]))
    with pytest.raises(RuntimeError, match="forward only"):
        tkk.rwkv6_scan_fwd(*args)
    with torch.no_grad():
        y, _ = tkk.rwkv6_scan_fwd(*args)
    assert y.shape == (1, 1, 4, 16)
