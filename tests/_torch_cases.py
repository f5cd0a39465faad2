"""Seeded NumPy inputs shared by the port's kernel tests (no JAX here, so
the on-card tests run where only torch is installed)."""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.paged_attention.ops import build_ragged_descriptor


def rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def shard_stack(mono, W):
    """The (W, Bs, M) interleaved shard stack of a (B, M) table: slot b at
    shard b % W, row b // W; rows past B stay -1."""
    B, M = mono.shape
    stack = np.full((W, -(-B // W), M), -1, np.int32)
    for b in range(B):
        stack[b % W, b // W] = mono[b]
    return stack


def tables(rng, B, M, N, W):
    """A (B, M) table of distinct blocks and its (W, Bs, M) shard stack."""
    mono = rng.permutation(N)[:B * M].reshape(B, M).astype(np.int32)
    return mono, shard_stack(mono, W)


def paged_case(seed, *, B=5, H=4, KV=2, hd=16, bs=128, M=4, W=1,
               window=None):
    """Decode inputs with holes that never cover a slot's last visible
    block (an all-hole window is where kernel and oracle legitimately
    differ: 0 vs a mean of masked garbage)."""
    rng = np.random.RandomState(seed)
    N = B * M + 3
    mono, _ = tables(rng, B, M, N, 1)
    lengths = rng.randint(1, M * bs + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        last = (lengths[b] - 1) // bs
        hole = (last + 1) % M if M > 1 else None
        if hole is not None and hole != last:
            mono[b, hole] = -1
    stack = shard_stack(mono, W)
    return dict(q=rand(rng, B, H, hd), kv=rand(rng, N, bs, 2 * KV, hd),
                mono=mono, stack=stack, lengths=lengths, window=window)


PAGED = [dict(W=1), dict(W=2), dict(W=4), dict(W=2, window=200),
         dict(W=4, window=77, M=3)]


def ragged_case(seed, *, W, window, KV=2, G=2, hd=16, bs=128):
    """Unaligned prefill rows (one resuming mid-prompt), decode rows (one
    over a hole in its history), an inactive slot."""
    rng = np.random.RandomState(seed)
    B, M = 6, 4
    N = B * M + 2
    mono, _ = tables(rng, B, M, N, 1)
    rows = [(0, 37, 0), (1, 20, 128), (2, 1, 300), (4, 1, 0), (5, 9, 256)]
    for slot, qn, start in rows:
        mono[slot, -(-(start + qn) // bs):] = -1
    mono[3] = -1
    mono[2, 1] = -1
    d = build_ragged_descriptor(
        [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
        [r[1] + r[2] for r in rows], num_slots=B, t_cap=96)
    stack = shard_stack(mono, W)
    T = d["token_row"].shape[0]
    return dict(q=rand(rng, T, KV * G, hd),
                kv=rand(rng, N, bs, 2 * KV, hd), mono=mono, stack=stack,
                d=d, window=window)


RAGGED = [dict(W=1, window=None), dict(W=2, window=None),
          dict(W=4, window=None), dict(W=2, window=50)]
