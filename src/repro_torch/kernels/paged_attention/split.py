"""Split-K over the key axis for the paged-attention kernels.

The CUDA kernels cut each slot's key axis into splits of a fixed number of
keys (:data:`DECODE_SPLIT`, :data:`RAGGED_SPLIT`).  One CTA serves one
(unit, KV head, split), where a unit is a decode slot or a ragged query
tile, and keeps an online softmax ``(m, l, acc)`` over its split's keys:
``m`` the running max of the scaled scores, ``l = Σ exp(s - m)`` and
``acc = Σ exp(s - m) · v``.  The split count comes from shapes alone,
``ceil(M · bs / split)``, so the wrappers never read a length back to the
host.

Which splits a unit touches follows from its descriptor
(:func:`unit_range`): the splits from the one holding its first visible
key to the one holding its last.  A unit that touches one split (or
none) writes its output directly from that split's CTA; otherwise each
touched split writes a partial into scratch (a split of holes writes the
empty partial ``m = NEG_INF, l = 0, acc = 0``) and a second kernel merges
them in split order by the log-sum-exp rule of :func:`merge_partials`.
CTAs of untouched splits exit without writing.

This module mirrors that arithmetic in Python: the split geometry used by
the wrappers, and plain partials and their merge, which the tests hold
against the whole-range plain versions in ``ref.py``.  The main path
runs none of the plain functions.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import (NEG_INF, assemble_shard_tables,
                                          split_fused_kv)

#: keys per split of the decode kernel (8 tiles of 32 keys)
DECODE_SPLIT = 256
#: keys per split of the ragged kernel, unless its scratch would pass
#: :data:`RAGGED_SCRATCH_CAP` (see :func:`ragged_split`)
RAGGED_SPLIT = 512
#: the most bytes the ragged kernel's split-K scratch may take: at an
#: engine's token capacity (granite: 2048 rows x 8 KV x 4 G x 128 hd) one
#: split's partials are 34 MB
RAGGED_SCRATCH_CAP = 256_000_000


def num_splits(keys: int, split: int) -> int:
    """Splits that cover a key axis of ``keys`` (``M * bs``) positions."""
    return max(1, -(-int(keys) // int(split)))


def ragged_split(keys: int, out_shape) -> int:
    """Keys per split of the ragged kernel for a key axis of ``keys``
    positions and an output of ``out_shape`` (T, KV, G, hd):
    :data:`RAGGED_SPLIT`, or the fewest equal splits (a multiple of 32
    keys) whose scratch stays within :data:`RAGGED_SCRATCH_CAP`."""
    want = num_splits(keys, RAGGED_SPLIT)
    per = scratch_bytes(out_shape, 2) // 2
    fit = max(1, RAGGED_SCRATCH_CAP // per)
    if want <= fit:
        return RAGGED_SPLIT
    return -(-int(keys) // (fit * 32)) * 32


def unit_range(qpos0: int, qrows: int, kv_len: int, window: int | None,
               split: int) -> tuple[int, int]:
    """``(s0, s1)``: the first and last split holding a key that some row
    of the unit may see.  Rows sit at positions ``qpos0 .. qpos0 + qrows -
    1``; a row sees ``kpos <= min(qpos, kv_len - 1)`` and, with a window,
    ``kpos > qpos - window``.  A unit that sees nothing gets ``(0, 0)``:
    split 0 writes its zeros."""
    lo = max(0, qpos0 - window + 1) if window else 0
    hi = min(qpos0 + qrows - 1, kv_len - 1)
    if hi < lo:
        return 0, 0
    return lo // split, hi // split


def scratch_shapes(out_shape, nsplit: int):
    """Shapes of the partial accumulators ``(nsplit, *out_shape)`` and of
    the partial ``(m, l)`` pairs ``(nsplit, *out_shape[:-1], 2)``; None
    when one split covers every key (no merge, no scratch)."""
    if nsplit <= 1:
        return None
    return (nsplit, *out_shape), (nsplit, *out_shape[:-1], 2)


def scratch_bytes(out_shape, nsplit: int) -> int:
    """f32 bytes of the scratch :func:`scratch_shapes` describes."""
    shapes = scratch_shapes(out_shape, nsplit)
    if shapes is None:
        return 0
    return 4 * sum(int(torch.Size(s).numel()) for s in shapes)


# ------------------------------------------------------ plain partials
def partial_softmax(s: torch.Tensor, visible: torch.Tensor,
                    v: torch.Tensor):
    """One split's online-softmax state over scaled scores ``s (..., S)``
    where ``visible (..., S)``, with values ``v (..., S, hd)``: ``m`` the
    max visible score (NEG_INF if none), ``l`` and ``acc`` as in the
    module docstring (exactly 0 where nothing is visible)."""
    m = torch.where(visible, s, NEG_INF).amax(dim=-1)
    p = torch.where(visible, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("...s,...sd->...d", p, v)


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """Merge per-split states stacked on dim 0 (``m``, ``l``: (S, ...);
    ``acc``: (S, ..., hd)) into the normalized output, in split order:
    ``Σ_s e^{m_s - M} acc_s / Σ_s e^{m_s - M} l_s`` with ``M = max_s m_s``.
    An empty split (``l = 0``) weighs exactly 0; a row that sees nothing
    comes out 0."""
    mx = m.amax(dim=0)
    w = torch.exp(m - mx)
    den = (w * l).sum(dim=0)
    num = (w[..., None] * acc).sum(dim=0)
    return torch.where(den[..., None] > 0,
                       num / den.clamp(min=1e-30)[..., None], 0.0)


def _split_states(s, visible, v, kpos, split, nsplit):
    ms, ls, accs = [], [], []
    for j in range(nsplit):
        vis = visible & (kpos // split == j)
        m, l, acc = partial_softmax(s, vis, v)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def decode_partials_ref(q: torch.Tensor, kv_pool: torch.Tensor,
                        shard_tables: torch.Tensor, lengths: torch.Tensor, *,
                        window: int | None = None,
                        split: int = DECODE_SPLIT):
    """Per-split states of fused-pool paged decode.  q: (B, KV, G, hd);
    kv_pool: (N, bs, 2KV, hd); shard_tables: (W, Bs, M) → ``m``, ``l``:
    (nsplit, B, KV, G) and ``acc``: (nsplit, B, KV, G, hd), the keys of
    split j being positions ``[j * split, (j + 1) * split)``."""
    B, KV, G, hd = q.shape
    k_pool, v_pool = split_fused_kv(kv_pool)
    bs = k_pool.shape[1]
    tables = assemble_shard_tables(shard_tables)[:B]
    M = tables.shape[1]
    phys = tables.clamp(min=0).long()
    k = k_pool[phys].reshape(B, M * bs, KV, hd).float()
    v = v_pool[phys].reshape(B, M * bs, KV, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float() / hd ** 0.5, k)
    kpos = torch.arange(M * bs, device=q.device)
    n = lengths.to(q.device)[:, None]
    vis = (kpos < n) & (tables.repeat_interleave(bs, dim=1) >= 0)
    if window is not None:
        vis &= kpos > n - 1 - window
    vis = vis[:, None, None, :].expand_as(s)
    vv = v.permute(0, 2, 1, 3)[:, :, None]                # (B,KV,1,S,hd)
    return _split_states(s, vis, vv, kpos, split, num_splits(M * bs, split))


def ragged_partials_ref(q: torch.Tensor, kv_pool: torch.Tensor,
                        shard_tables: torch.Tensor, token_row: torch.Tensor,
                        token_pos: torch.Tensor, kv_lens: torch.Tensor, *,
                        window: int | None = None,
                        split: int = RAGGED_SPLIT):
    """Per-split states of the ragged kernel.  q: (T, KV, G, hd) packed
    rows; token_row/token_pos: (T,) slot (-1 = padding) and position →
    ``m``, ``l``: (nsplit, T, KV, G), ``acc``: (nsplit, T, KV, G, hd);
    padding rows see nothing."""
    T, KV, G, hd = q.shape
    k_pool, v_pool = split_fused_kv(kv_pool)
    bs = k_pool.shape[1]
    mono = assemble_shard_tables(shard_tables)
    M = mono.shape[1]
    nsplit = num_splits(M * bs, split)
    kpos = torch.arange(M * bs, device=q.device)
    m = torch.full((nsplit, T, KV, G), NEG_INF, device=q.device)
    l = torch.zeros((nsplit, T, KV, G), device=q.device)
    acc = torch.zeros((nsplit, T, KV, G, hd), device=q.device)
    for slot in torch.unique(token_row[token_row >= 0]).tolist():
        rows = (token_row == slot).nonzero()[:, 0]
        tab = mono[slot]
        phys = tab.clamp(min=0).long()
        k = k_pool[phys].reshape(M * bs, KV, hd).float()
        v = v_pool[phys].reshape(M * bs, KV, hd).float()
        s = torch.einsum("tkgd,skd->tkgs", q[rows].float() / hd ** 0.5, k)
        qpos = token_pos[rows][:, None]
        vis = (kpos <= qpos) & (kpos < kv_lens[slot]) & (
            tab.repeat_interleave(bs)[None, :] >= 0)
        if window is not None:
            vis &= kpos > qpos - window
        vis = vis[:, None, None, :].expand_as(s)
        vv = v.permute(1, 0, 2)[None, :, None]           # (1,KV,1,S,hd)
        pm, pl, pacc = _split_states(s, vis, vv, kpos, split, nsplit)
        m[:, rows], l[:, rows], acc[:, rows] = pm, pl, pacc
    return m, l, acc


__all__ = ["DECODE_SPLIT", "RAGGED_SPLIT", "num_splits", "unit_range",
           "scratch_shapes", "scratch_bytes", "partial_softmax",
           "merge_partials", "decode_partials_ref", "ragged_partials_ref"]
