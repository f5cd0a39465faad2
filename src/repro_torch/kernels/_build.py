"""Build the port's CUDA sources into shared libraries and load them.

The sources have a plain C interface (one ``extern "C"`` launcher per
kernel that returns ``cudaGetLastError()``), so each build is one ``nvcc``
call of a few seconds: no PyTorch headers, no extension machinery.  Each
source of :data:`SOURCES` is its own library in
``build/repro_torch_kernels/lib<hash>.so`` at the root of the checkout,
keyed by a hash of the source, the shared headers in ``kernels/csrc/``
and the flags, built at first use (or all at once, in parallel, by
:func:`build_all`).  Nothing here runs at import
time, so the package imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: sm_90a keeps wgmma/setmaxnreg available; no --use_fast_math, so expf
#: stays exact enough for exp(NEG_INF - m) to underflow to 0.0
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_KERNELS = Path(__file__).resolve().parent
#: every CUDA source of the port, one library each
SOURCES = tuple(_KERNELS / name / "csrc" / f"{name}.cu" for name in (
    "paged_attention", "mla_attention", "mamba_scan", "rwkv6_scan",
    "flash_attention"))
#: headers the sources include (``#include "../../csrc/<name>.cuh"``); part
#: of every library's hash
HEADERS = tuple(sorted((_KERNELS / "csrc").glob("*.cuh")))

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build on a machine with the CUDA toolkit")
    return path


def library_path(sources) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *HEADERS):
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def build(sources) -> Path:
    """Compile ``sources`` unless the hashed library exists; returns it.

    Raises ``RuntimeError`` with nvcc's output when the build fails.  The
    library is written to a temporary name and renamed into place, so
    concurrent builders never load a half-written file.
    """
    out = library_path(sources)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(sources=SOURCES) -> list[Path]:
    """Build one library per source, all nvcc processes at once; returns
    the libraries in the order of ``sources``."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return list(pool.map(lambda src: build((src,)), sources))


def load(sources) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``sources``, once per
    process."""
    path = str(build(sources))
    if path not in _LOADED:
        _LOADED[path] = ctypes.CDLL(path)
    return _LOADED[path]
