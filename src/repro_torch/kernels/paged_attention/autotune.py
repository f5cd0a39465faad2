"""Tuning cache and CUDA-event tuner for the fused paged-decode kernel.

Keyed by the kernel-shape triple ``(heads, head_dim, bs)`` and the
pool's dtype (``dtype=``, float32 unless given: a bf16 page's copies
are half as large, so it gets its own depth); the engine and
``decode_step`` read the tuned ``buffer_depth`` through
:func:`get_tuning` for their pool's dtype.  Without a recorded entry
every key falls back to :data:`DEFAULT_BUFFER_DEPTH`, so two engines
decode identical tokens whether or not anything was tuned (the depth
never changes the kernel's output anyway).  :func:`autotune` times the kernel on the card at each
depth with CUDA events and records the fastest.

The reference's ``KernelCostModel`` is not carried over: it ranks depths
by a modelled TPU DMA-descriptor, per-byte and semaphore-wait cost,
which has no meaning on the card, where the depth is the number of
``cp.async`` tiles in flight and only a timing can rank it.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field

import torch

#: depths the kernel is built for (1 = no copy in flight behind compute)
BUFFER_DEPTHS = (1, 2, 4)

#: deterministic fallback when nothing has been recorded
DEFAULT_BUFFER_DEPTH = 2


@dataclass(frozen=True)
class KernelTuning:
    """One cache entry: the chosen (block_size, buffer_depth), and for an
    entry :func:`autotune` recorded the median ms of one call at each
    depth it timed."""

    block_size: int
    buffer_depth: int
    ms: dict | None = field(default=None, compare=False)


_CACHE: dict[tuple, KernelTuning] = {}


def tuning_key(heads: int, head_dim: int, bs: int, *,
               dtype: torch.dtype = torch.float32) -> tuple:
    """``(heads, head_dim, bs, dtype)``: the pool's dtype is part of the
    key."""
    return (int(heads), int(head_dim), int(bs), dtype)


def get_tuning(heads: int, head_dim: int, bs: int, *,
               dtype: torch.dtype = torch.float32) -> KernelTuning:
    """The recorded entry for this shape and pool dtype, or the
    deterministic default."""
    return _CACHE.get(tuning_key(heads, head_dim, bs, dtype=dtype),
                      KernelTuning(block_size=int(bs),
                                   buffer_depth=DEFAULT_BUFFER_DEPTH))


def set_tuning(heads: int, head_dim: int, bs: int, tuning: KernelTuning, *,
               dtype: torch.dtype = torch.float32) -> None:
    if tuning.buffer_depth not in BUFFER_DEPTHS:
        raise ValueError(f"buffer_depth must be one of {BUFFER_DEPTHS}, "
                         f"got {tuning.buffer_depth}")
    _CACHE[tuning_key(heads, head_dim, bs, dtype=dtype)] = tuning


def clear() -> None:
    """Drop all recorded entries (tests)."""
    _CACHE.clear()


def autotune(heads: int, head_dim: int, bs: int, n_blocks: int, *,
             batch: int, group: int, device="cuda", reps: int = 20,
             dtype: torch.dtype = torch.float32) -> KernelTuning:
    """Time ``ops.paged_attention`` at every depth of
    :data:`BUFFER_DEPTHS` on the card and record the fastest.

    The inputs are seeded: a fused pool of ``batch · n_blocks`` blocks
    ``(N, bs, 2·heads, head_dim)``, each of the ``batch`` slots owning
    ``n_blocks`` of them through a one-shard ``(1, batch, n_blocks)``
    table and seeing all ``n_blocks · bs`` tokens, with ``group`` query
    heads per KV head; the pool and the queries in ``dtype``, the entry
    recorded under it.  Each depth is warmed up, then timed ``reps``
    times with CUDA events around one call; the median counts.  The
    entry's ``ms`` holds the medians.  Raises off a CUDA device: there
    is no modelled fallback."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"autotune times the CUDA kernel with CUDA "
                           f"events; it cannot run on {device}")
    from repro_torch.kernels.paged_attention import ops

    gen = torch.Generator(device=device).manual_seed(0)
    N = batch * n_blocks
    kv = torch.randn(N, bs, 2 * heads, head_dim, generator=gen,
                     device=device).to(dtype)
    q = torch.randn(batch, heads * group, head_dim, generator=gen,
                    device=device).to(dtype)
    tables = torch.arange(N, dtype=torch.int32, device=device).reshape(
        1, batch, n_blocks)
    lengths = torch.full((batch,), n_blocks * bs, dtype=torch.int32,
                         device=device)
    ms = {}
    for depth in BUFFER_DEPTHS:
        def call():
            return ops.paged_attention(q, kv, tables, lengths,
                                       buffer_depth=depth)
        for _ in range(3):
            call()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms[depth] = statistics.median(times)
    tuning = KernelTuning(block_size=int(bs),
                          buffer_depth=min(ms, key=ms.get), ms=ms)
    set_tuning(heads, head_dim, bs, tuning, dtype=dtype)
    return tuning


__all__ = ["KernelTuning", "BUFFER_DEPTHS", "DEFAULT_BUFFER_DEPTH",
           "tuning_key", "get_tuning", "set_tuning", "autotune", "clear"]
