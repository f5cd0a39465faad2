"""The RWKV-6 kernel's chunked schedule, on the CPU.

The CUDA kernel runs the WKV recurrence in chunks of 32 tokens in direct
form, over ``col_split`` groups of value columns, and runs a chunk whose
cumulated decay passes the kernel's limit token by token
(``repro_torch.kernels.rwkv6_scan.ref.rwkv6_chunked_ref`` mirrors it).
These tests hold that schedule against the Pallas kernel run in interpret
mode (the reference's own way on the CPU) and against the sequential
oracle ``_wkv_sequential``, at the reference's tolerance, 2e-4 x max(1,
|want|).  The kernel itself is held against the oracle on the card
(``tests/test_torch_kernels_cuda.py``).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.rwkv6_scan import ops as jrk  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as trk  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as tkk  # noqa: E402
from _torch_cases import (RWKV6_CHUNKED, rwkv6_case,  # noqa: E402
                          rwkv6_strong_case)

SCAN_TOL = 2e-4
KEYS = ("r", "k", "v", "w", "u", "S0")


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=SCAN_TOL * scale)


@pytest.mark.parametrize("case,col_split", RWKV6_CHUNKED, ids=str)
def test_chunked_schedule_matches_pallas_interpret(case, col_split):
    c = rwkv6_case(30, **case)
    args = [c[k] for k in KEYS]
    wy, ws = jrk.rwkv6_scan(*map(jnp.asarray, args), interpret=True)
    gy, gs = ref.rwkv6_chunked_ref(*map(t, args), col_split=col_split)
    close(gy, wy)
    close(gs, ws)
    sy, ss = ref.rwkv6_scan_ref(*map(t, args))
    close(gy, sy)
    close(gs, ss)
    assert ref.fast_chunks(t(c["w"])).all()


@pytest.mark.parametrize("zero_w", [False, True])
@pytest.mark.parametrize("col_split", [1, 2, 4])
def test_chunks_past_the_decay_limit_take_the_sequential_path(col_split,
                                                              zero_w):
    """Strong decays on the even heads (log w down to -5, and with
    ``zero_w`` one w of exactly 0): their chunks run token by token, the
    odd heads' in direct form; the result equals the sequential oracle and
    is finite."""
    c = rwkv6_strong_case(31, B=2, S=75, nH=4, hd=32, zero_w=zero_w)
    args = [t(c[k]) for k in KEYS]
    fast = ref.fast_chunks(args[3])
    assert not fast[:, :, ::2].all() and fast[:, :, 1::2].all()
    gy, gs = ref.rwkv6_chunked_ref(*args, col_split=col_split)
    sy, ss = ref.rwkv6_scan_ref(*args)
    assert torch.isfinite(gy).all() and torch.isfinite(gs).all()
    close(gy, sy)
    close(gs, ss)
    # the direct form alone is not finite there once a w is 0
    if zero_w:
        ny, _ = ref.rwkv6_chunked_ref(*args, threshold=float("inf"))
        assert not torch.isfinite(ny).all()


def test_decay_limit_matches_the_kernel_source():
    src = (Path(tkk.__file__).parent / "csrc" / "rwkv6_scan.cu").read_text()
    assert re.search(r"constexpr int C = (\d+);", src).group(1) == str(
        ref.CHUNK)
    limit = re.search(r"constexpr float DECAY_LIMIT = ([\d.]+)f;", src)
    assert float(limit.group(1)) == ref.DECAY_LIMIT


def test_op_on_cpu_is_the_sequential_oracle_token_major():
    """``ops.rwkv6_scan`` hands the wrapper token-major views (no padding,
    no copies); on the CPU the wrapper runs the oracle."""
    c = rwkv6_case(32, B=2, S=45, nH=3, hd=32)
    args = [t(c[k]) for k in KEYS]
    gy, gs = trk.rwkv6_scan(*args)
    sy, ss = ref.rwkv6_scan_ref(*args)
    assert gy.shape == sy.shape == (2, 45, 3, 32)
    np.testing.assert_array_equal(gy.numpy(), sy.numpy())
    np.testing.assert_array_equal(gs.numpy(), ss.numpy())
