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
#: d_state values the kernel instantiates (N adjacent lanes per channel)
_STATES = (1, 2, 4, 8, 16, 32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load((SOURCE,))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mamba_scan_launch.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.mamba_scan_launch.restype = i
    return lib


def mamba_scan_fwd(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """dt, x: (B, S, DI); A: (DI, N); B, C: (B, S, N); h0: (B, DI, N), all
    f32 → (y (B, S, DI), h_last (B, DI, N))."""
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
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C), ("x", x),
                    ("h0", h0)):
        _check(name, t, torch.float32, dt.device)
    if N not in _STATES:
        raise ValueError(f"d_state {N} unsupported: the kernel takes "
                         f"{_STATES}")
    y = torch.empty_like(dt)
    h_last = torch.empty_like(h0)
    code = _lib().mamba_scan_launch(
        dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        x.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), Bsz,
        S, DI, N, _stream(dt.device))
    _raise_on(code, "mamba_scan_kernel")
    LAUNCHES["mamba_scan"] += 1
    return y, h_last
