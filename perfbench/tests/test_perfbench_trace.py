"""The reduction of a profiler trace: busy time inside the window, the
time of the device operations each kernel wrapper launched, and idle
gaps labelled by the innermost host range open when each began."""

import numpy as np
import pytest

from perfbench import trace
from perfbench.metrics import _roofline

MS = 1_000_000


def _ev():
    return [
        ("annotation", trace.WINDOW, 0, 100 * MS, None),
        ("annotation", "engine.step", 5 * MS, 60 * MS, None),
        ("annotation", "admission", 5 * MS, 20 * MS, None),
        ("annotation", "decode_step", 20 * MS, 50 * MS, None),
        ("annotation", "kernel.paged_decode", 22 * MS, 23 * MS, None),
        ("launch", "cudaLaunchKernel", 22 * MS, 22 * MS + 10, 1),
        ("launch", "cudaLaunchKernel", 22 * MS + 500, 22 * MS + 510, 2),
        ("launch", "cudaLaunchKernel", 24 * MS, 24 * MS + 10, 3),
        ("device", "", 30 * MS, 40 * MS, 1),
        ("device", "void merge_kernel<float>(float const*)", 40 * MS,
         45 * MS, 2),
        ("device", "ampere_bf16_gemm", 44 * MS, 55 * MS, 3),
        ("device", "late_kernel", 95 * MS, 130 * MS, None),  # cut at w1
    ]


def test_reduce_busy_kernels_and_gaps():
    r = trace.reduce(_ev())
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.025 + 0.005)
    assert r["kernel_time"] == {"paged_decode": pytest.approx(0.015)}
    assert r["kernels"]["merge_kernel<float>"] == pytest.approx(0.005)
    gaps = r["idle_gaps"]
    # 0-30 began outside every range; 55-95 inside engine.step
    assert gaps[trace.OUTSIDE] == pytest.approx(0.030)
    assert gaps["engine.step"] == pytest.approx(0.040)


def test_short_name():
    n = "void ns::ragged_kernel<4, float, __nv_bfloat16>(Args const*, int)"
    assert trace.short_name(n) == "ns::ragged_kernel<4, float, __nv_bfloat16>"


class _Rec:
    dims = {"heads": 4, "kv_heads": 2, "head_dim": 8, "attn_layers": 2,
            "mla_layers": 0, "block": 4, "pool_bytes": 2, "act_bytes": 2,
            "table_cols": 2}

    def __init__(self, ktime, calls):
        self.trace = {"kernel_time": ktime}

        class T:
            decode_calls = calls
            ragged_calls = []
        self.tracer = T()


def test_roofline_share():
    from perfbench.work import paged_decode
    call = (np.array([[0, 1]]), np.array([6]))
    f, b = paged_decode.work(call, _Rec.dims)
    bound = max(2 * f / 989e12, 2 * b / 3.35e12)
    got = _roofline.share(_Rec({"paged_decode": 2e-3}, [call, call]),
                          "paged_decode")
    assert got == pytest.approx(100 * 2 * bound / 2e-3)
    assert _roofline.share(_Rec({}, [call]), "paged_decode") is None
    assert _roofline.share(_Rec({"paged_decode": 1.0}, []),
                           "paged_decode") is None


def test_every_kernel_module_names_a_wrapper_of_the_port():
    import importlib

    from perfbench import work
    assert work.kernels() == ["mla", "paged_decode", "ragged"]
    for k in work.kernels():
        mod, attr = importlib.import_module(f"perfbench.work.{k}").WRAPS
        assert callable(getattr(importlib.import_module(mod), attr))
