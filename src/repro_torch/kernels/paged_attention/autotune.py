"""In-process tuning cache for the fused paged-decode kernel.

Keyed by the kernel-shape triple ``(heads, head_dim, bs)``; the engine
reads the tuned ``buffer_depth`` through :func:`get_tuning`.  Without a
recorded entry every key falls back to :data:`DEFAULT_BUFFER_DEPTH`, so
two engines decode identical tokens whether or not anything was tuned
(the depth never changes the kernel's output anyway).  The reference's
TPU cost model is not carried over: a sweep timed with CUDA events on
the card is what will record entries here.
"""

from __future__ import annotations

from dataclasses import dataclass

#: depths the kernel is built for (1 = no copy in flight behind compute)
BUFFER_DEPTHS = (1, 2, 4)

#: deterministic fallback when nothing has been recorded
DEFAULT_BUFFER_DEPTH = 2


@dataclass(frozen=True)
class KernelTuning:
    """One cache entry: the chosen (block_size, buffer_depth)."""

    block_size: int
    buffer_depth: int


_CACHE: dict[tuple[int, int, int], KernelTuning] = {}


def tuning_key(heads: int, head_dim: int, bs: int) -> tuple[int, int, int]:
    return (int(heads), int(head_dim), int(bs))


def get_tuning(heads: int, head_dim: int, bs: int) -> KernelTuning:
    """The recorded entry for this shape, or the deterministic default."""
    return _CACHE.get(tuning_key(heads, head_dim, bs),
                      KernelTuning(block_size=int(bs),
                                   buffer_depth=DEFAULT_BUFFER_DEPTH))


def set_tuning(heads: int, head_dim: int, bs: int,
               tuning: KernelTuning) -> None:
    if tuning.buffer_depth not in BUFFER_DEPTHS:
        raise ValueError(f"buffer_depth must be one of {BUFFER_DEPTHS}, "
                         f"got {tuning.buffer_depth}")
    _CACHE[tuning_key(heads, head_dim, bs)] = tuning


def clear() -> None:
    """Drop all recorded entries (tests)."""
    _CACHE.clear()


__all__ = ["KernelTuning", "BUFFER_DEPTHS", "DEFAULT_BUFFER_DEPTH",
           "tuning_key", "get_tuning", "set_tuning", "clear"]
