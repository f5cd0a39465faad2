"""Wrapper of the selective-scan CUDA kernel (``csrc/mamba_scan.cu``).

:func:`mamba_scan_fwd` takes the layouts of its TPU counterpart in
``repro.kernels.mamba_scan.mamba_scan``.  On a CPU tensor it runs the
plain version from ``ref.py``; on a CUDA tensor it launches the kernel on
the current stream or raises.  Forward only: inputs that require grad are
refused.  :data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.mamba_scan import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    _check, _forward_only, _raise_on, _stream)

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"mamba_scan": 0}

SOURCE = Path(__file__).parent / "csrc" / "mamba_scan.cu"
#: d_state values the kernel instantiates (one thread holds a channel's N
#: states)
_STATES = (1, 2, 4, 8, 16, 32)
#: the kernel's geometry (``CH``, ``TC``, ``STAGES`` in the source):
#: channels per block (one warp), time steps per ring stage, ring stages
CHANNELS_PER_BLOCK, STEPS_PER_STAGE, RING_STAGES = 32, 32, 3


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load((SOURCE,))
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.mamba_scan_launch.argtypes = ([p] * 8 + [i] * 4 + [ll] * 8 + [i] * 2
                                      + [p])
    lib.mamba_scan_launch.restype = i
    return lib


def _strides(t: torch.Tensor):
    """(batch, token) strides of a (B, S, ·) tensor as the kernel reads it
    (0 for a dimension of size 1), or None if its last stride is not 1."""
    if t.stride(-1) != 1:
        return None
    return tuple(0 if n == 1 else s for n, s in zip(t.shape[:2],
                                                      t.stride()[:2]))


def _aligned16(t: torch.Tensor, st) -> bool:
    """Rows of t start on 16-byte boundaries (16-byte copies allowed)."""
    return t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in st)


def mamba_scan_fwd(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """dt, x: (B, S, DI); A: (DI, N); B, C: (B, S, N); h0: (B, DI, N), all
    f32 → (y (B, S, DI), h_last (B, DI, N)), both contiguous.

    dt, x, B and C may have any (batch, token) strides: the kernel reads
    them in place, so column views of a wider tensor cost no copy.  Only
    a tensor whose last stride is not 1 is made contiguous first; rows
    that are not 16-byte aligned are read with 4-byte copies."""
    Bsz, S, DI = dt.shape
    N = A.shape[1]
    if (x.shape != dt.shape or A.shape != (DI, N)
            or B.shape != (Bsz, S, N) or C.shape != (Bsz, S, N)
            or h0.shape != (Bsz, DI, N)):
        raise ValueError(f"shapes do not match: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, x {tuple(x.shape)}, h0 "
                         f"{tuple(h0.shape)}")
    _forward_only("mamba_scan", dt, A, B, C, x, h0)
    if dt.device.type == "cpu":
        return ref.mamba_scan_ref(dt, A, B, C, x, h0)
    for name, t in (("A", A), ("h0", h0)):
        _check(name, t, (torch.float32,), dt.device)
    for name, t in (("dt", dt), ("B", B), ("C", C), ("x", x)):
        if t.device != dt.device or t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, the "
                             f"kernel takes torch.float32 on {dt.device}")
    if N not in _STATES:
        raise ValueError(f"d_state {N} unsupported: the kernel takes "
                         f"{_STATES}")
    dt, B, C, x = (t if _strides(t) is not None else t.contiguous()
                   for t in (dt, B, C, x))
    st = {k: _strides(t) for k, t in (("dt", dt), ("x", x), ("B", B),
                                      ("C", C))}
    y = torch.empty((Bsz, S, DI), dtype=torch.float32, device=dt.device)
    h_last = torch.empty_like(h0)
    vec_dx = DI % 4 == 0 and _aligned16(dt, st["dt"]) and _aligned16(
        x, st["x"])
    vec_bc = N % 4 == 0 and _aligned16(B, st["B"]) and _aligned16(
        C, st["C"])
    code = _lib().mamba_scan_launch(
        dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        x.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), Bsz,
        S, DI, N, *st["dt"], *st["x"], *st["B"], *st["C"], int(vec_dx),
        int(vec_bc), _stream(dt.device))
    _raise_on(code, "mamba_scan_kernel")
    LAUNCHES["mamba_scan"] += 1
    return y, h_last
