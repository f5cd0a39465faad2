"""Seeded NumPy inputs shared by the port's kernel tests (no JAX here, so
the on-card tests run where only torch is installed)."""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.paged_attention.ops import build_ragged_descriptor
from repro_torch.kernels.paged_attention.split import (DECODE_SPLIT,
                                                       RAGGED_SPLIT)


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


#: the (q, pool) element types the paged-attention kernels take besides
#: (float32, float32), by torch dtype name: the output has q's
BF16_PAIRS = [("float32", "bfloat16"), ("bfloat16", "bfloat16"),
              ("bfloat16", "float32")]

#: head_dim 36: a multiple of 4 but not of 8, so a bf16 row's V half and
#: odd heads sit 8 bytes off 16 (the kernels copy such rows 8 bytes at a
#: time)
PAGED_HD36 = [dict(W=1, hd=36), dict(W=2, hd=36, window=200)]
RAGGED_HD36 = [dict(W=1, window=None, hd=36), dict(W=2, window=50, hd=36)]


def paged_split_case(seed, *, G, KV, hd, W, window=None, bs=128, M=20):
    """Decode inputs whose key axis spans many splits of
    ``DECODE_SPLIT`` keys (M * bs = 2560 keys): lengths of split - 1,
    split and split + 1, one past four splits with split 1 made wholly of
    holes, a full table with a hole, and an inactive slot (length 0)."""
    S = DECODE_SPLIT
    rng = np.random.RandomState(seed)
    B = 6
    N = B * M + 3
    mono, _ = tables(rng, B, M, N, 1)
    lengths = np.array([S - 1, S, S + 1, 4 * S + 1, M * bs, 0], np.int32)
    mono[3, S // bs:2 * S // bs] = -1
    mono[4, 5] = -1
    mono[5] = -1
    return dict(q=rand(rng, B, KV * G, hd), kv=rand(rng, N, bs, 2 * KV, hd),
                mono=mono, stack=shard_stack(mono, W), lengths=lengths,
                window=window)


#: G in {1, 4, 5, 6}, hd in {64, 120, 128}, W in {1, 2, 4}, windows shorter
#: than a split; the last two at the head shapes of whisper-small (MHA: 12
#: KV heads of 64, one query head a CTA) and InternVL2-26B (8 KV heads of
#: 128, G 6)
PAGED_SPLITS = [dict(G=4, KV=2, hd=128, W=1),
                dict(G=1, KV=4, hd=120, W=2),
                dict(G=5, KV=2, hd=128, W=4, window=200),
                dict(G=4, KV=2, hd=120, W=1, window=200),
                dict(G=6, KV=1, hd=64, W=2),
                dict(G=1, KV=12, hd=64, W=1),
                dict(G=6, KV=8, hd=128, W=2)]


def ragged_split_case(seed, *, G, KV, hd, W, window=None, bs=128, M=33):
    """A mixed batch whose key axis spans five splits of ``RAGGED_SPLIT``
    keys (M * bs = 4224): a lone decode row at 4200 (a 1-real-row tile), a
    13-row prefill chunk across the first split boundary (its second tile
    ends in padding rows), decode rows at kv lengths split - 1, split and
    split + 1, a decode row at 3000 over split 1 made wholly of holes, a
    40-row chunk at 2040, an inactive slot and padding tiles."""
    S = RAGGED_SPLIT
    rng = np.random.RandomState(seed)
    B = 8
    N = B * M + 2
    mono, _ = tables(rng, B, M, N, 1)
    rows = [(0, 1, 4200), (1, 13, S - 4), (2, 1, S - 2), (3, 1, S - 1),
            (4, 1, S), (5, 1, 3000), (6, 40, 2040)]
    for slot, qn, start in rows:
        mono[slot, -(-(start + qn) // bs):] = -1
    mono[5, S // bs:2 * S // bs] = -1
    mono[7] = -1
    d = build_ragged_descriptor(
        [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
        [r[1] + r[2] for r in rows], num_slots=B, t_cap=128)
    T = d["token_row"].shape[0]
    return dict(q=rand(rng, T, KV * G, hd),
                kv=rand(rng, N, bs, 2 * KV, hd), mono=mono,
                stack=shard_stack(mono, W), d=d, window=window)


#: as PAGED_SPLITS, plus G = 6 (the widest tile, 48 MMA rows) and hd 64
#: and 96 (the kernel's other padded head widths); the last two at
#: whisper-small's and InternVL2-26B's head shapes
RAGGED_SPLITS = [dict(G=4, KV=2, hd=128, W=1),
                 dict(G=1, KV=4, hd=120, W=2),
                 dict(G=5, KV=2, hd=128, W=4, window=300),
                 dict(G=4, KV=2, hd=120, W=1, window=300),
                 dict(G=6, KV=1, hd=64, W=2),
                 dict(G=2, KV=2, hd=96, W=1, window=300),
                 dict(G=1, KV=12, hd=64, W=1),
                 dict(G=6, KV=8, hd=128, W=4)]


def mla_case(seed, *, B=5, H=4, rank=32, rope=8, bs=128, M=4, W=1):
    """Absorbed-MLA decode inputs: holes in the even slots, one slot whose
    pages are all holes and one slot of length 0 (both see nothing and
    give 0)."""
    rng = np.random.RandomState(seed)
    N = B * M + 3
    mono, _ = tables(rng, B, M, N, 1)
    lengths = rng.randint(1, M * bs + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        mono[b, rng.randint(M)] = -1
    mono[1] = -1
    lengths[-1] = 0
    return dict(q_lat=rand(rng, B, H, rank), q_rope=rand(rng, B, H, rope),
                c=rand(rng, N, bs, rank), kr=rand(rng, N, bs, rope),
                mono=mono, stack=shard_stack(mono, W), lengths=lengths,
                scale=float((16 + rope) ** -0.5))


MLA = [dict(W=1), dict(W=2), dict(W=4), dict(W=4, B=7, M=3),
       dict(W=1, H=16, rank=512, rope=64, M=2, B=3)]


def mla_split_case(seed, *, W, H, rank, rope, bs=128, M=4):
    """MLA inputs whose token axis spans two splits of ``MLA_SPLIT`` = 256
    (M * bs = 512): lengths 1, 255, 256 and 257 (a split's edges), a full
    slot whose pages 1 and 2 are holes (across the split boundary), a slot
    of 300 tokens whose second split is all holes, and a slot of length 0."""
    rng = np.random.RandomState(seed)
    B = 7
    N = B * M + 3
    mono, _ = tables(rng, B, M, N, 1)
    lengths = np.array([1, 255, 256, 257, M * bs, 300, 0], np.int32)
    mono[4, 1:3] = -1
    mono[5, 2:] = -1
    mono[6] = -1
    return dict(q_lat=rand(rng, B, H, rank), q_rope=rand(rng, B, H, rope),
                c=rand(rng, N, bs, rank), kr=rand(rng, N, bs, rope),
                mono=mono, stack=shard_stack(mono, W), lengths=lengths,
                scale=float((16 + rope) ** -0.5))


#: W in {1, 4}; H below, above and at the kernel's 16 heads per block;
#: DeepSeek-V2's rank and rope
MLA_SPLITS = [dict(W=1, H=4, rank=32, rope=8),
              dict(W=4, H=20, rank=64, rope=16),
              dict(W=4, H=16, rank=512, rope=64),
              dict(W=1, H=32, rank=512, rope=64)]


def softplus(a):
    return np.logaddexp(0.0, a).astype(np.float32)


def mamba_case(seed, *, B, S, DI, N, chunk=64):
    """Selective-scan inputs as the reference's kernel test draws them:
    dt = softplus(normal), A = -exp(0.2·normal), a nonzero h0."""
    rng = np.random.RandomState(seed)
    return dict(dt=softplus(rand(rng, B, S, DI)),
                A=-np.exp(0.2 * rand(rng, DI, N)).astype(np.float32),
                B=rand(rng, B, S, N), C=rand(rng, B, S, N),
                x=rand(rng, B, S, DI), h0=rand(rng, B, DI, N), chunk=chunk)


#: the reference's kernel-test cases (tests/test_kernels.py), then
#: sequences longer than one staged chunk, d_state 32 and 1, and channels
#: that do not fill a block; then one step, a sequence past the kernel's
#: ring (3 stages of 32 steps) that is a multiple of no chunk, and a
#: batch of one over several blocks with a partial last warp
MAMBA = [dict(B=2, S=32, DI=16, N=8, chunk=16),
         dict(B=1, S=100, DI=64, N=16, chunk=64),
         dict(B=2, S=64, DI=24, N=4, chunk=32),
         dict(B=2, S=300, DI=40, N=16),
         dict(B=1, S=70, DI=33, N=32),
         dict(B=1, S=9, DI=20, N=1),
         dict(B=2, S=1, DI=40, N=8),
         dict(B=1, S=157, DI=100, N=16),
         dict(B=1, S=45, DI=72, N=2)]


def rwkv6_case(seed, *, B, S, nH, hd, chunk=32):
    """WKV inputs as the reference's kernel test draws them: decays
    w = exp(-exp(0.5·normal - 0.5)) in (0, 1), small u and S0."""
    rng = np.random.RandomState(seed)
    sh = (B, S, nH, hd)
    return dict(r=rand(rng, *sh), k=rand(rng, *sh), v=rand(rng, *sh),
                w=np.exp(-np.exp(0.5 * rand(rng, *sh) - 0.5)).astype(
                    np.float32),
                u=(0.1 * rand(rng, nH, hd)).astype(np.float32),
                S0=(0.1 * rand(rng, B, nH, hd, hd)).astype(np.float32),
                chunk=chunk)


def rwkv6_strong_case(seed, *, B, S, nH, hd, zero_w=True):
    """WKV inputs with strong decays on the even heads: log w as in
    :func:`rwkv6_case`, times 4 and clipped at -5, so their chunks of 32
    fall past the kernel's decay limit (cum log w < -60) and take the
    sequential path, while the odd heads stay in direct form; with
    ``zero_w`` one decay is exactly 0 (log w = -inf)."""
    c = rwkv6_case(seed, B=B, S=S, nH=nH, hd=hd)
    logw = np.log(c["w"])
    logw[:, :, ::2] = np.maximum(4 * logw[:, :, ::2], -5.0)
    c["w"] = np.exp(logw).astype(np.float32)
    if zero_w:
        c["w"][0, min(S - 1, 40), 0, 3] = 0.0
    return c


#: (case, col_split): tails (S not a multiple of 32), head sizes 16/32/64,
#: every column split the kernel takes
RWKV6_CHUNKED = [(dict(B=2, S=45, nH=3, hd=32), 1),
                 (dict(B=2, S=45, nH=3, hd=32), 4),
                 (dict(B=1, S=100, nH=4, hd=64), 2),
                 (dict(B=1, S=100, nH=4, hd=64), 4),
                 (dict(B=2, S=32, nH=2, hd=16), 2),
                 (dict(B=1, S=70, nH=2, hd=64), 1)]


RWKV6 = [dict(B=2, S=32, nH=2, hd=16, chunk=16),
         dict(B=1, S=100, nH=4, hd=64, chunk=32),
         dict(B=2, S=45, nH=3, hd=32)]


def flash_case(seed, *, B, Sq, Sk, H, KV, hd, causal, window):
    """Flash-attention inputs; causal cases put the queries at the end of
    the keys (``q_offset = Sk - Sq``), as the reference's kernel test."""
    rng = np.random.RandomState(seed)
    return dict(q=rand(rng, B, Sq, H, hd), k=rand(rng, B, Sk, KV, hd),
                v=rand(rng, B, Sk, KV, hd), causal=causal, window=window,
                q_offset=Sk - Sq if causal else 0)


#: the reference's kernel-test cases, then danube's head_dim 120 with a
#: window, a non-causal window and several query tiles over a long window
FLASH = [dict(B=2, Sq=64, Sk=64, H=4, KV=2, hd=32, causal=True, window=None),
         dict(B=1, Sq=100, Sk=100, H=4, KV=4, hd=16, causal=True,
              window=None),
         dict(B=2, Sq=128, Sk=128, H=8, KV=2, hd=64, causal=True, window=32),
         dict(B=1, Sq=33, Sk=77, H=2, KV=1, hd=16, causal=False,
              window=None),
         dict(B=2, Sq=16, Sk=144, H=4, KV=2, hd=32, causal=True,
              window=None),
         dict(B=1, Sq=200, Sk=200, H=4, KV=1, hd=120, causal=True,
              window=70),
         dict(B=1, Sq=50, Sk=90, H=2, KV=2, hd=128, causal=False, window=40),
         dict(B=1, Sq=300, Sk=300, H=2, KV=1, hd=128, causal=True,
              window=None),
         dict(B=1, Sq=130, Sk=130, H=4, KV=2, hd=36, causal=True,
              window=None),
         dict(B=2, Sq=70, Sk=200, H=4, KV=1, hd=120, causal=True,
              window=20)]
