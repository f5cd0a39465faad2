"""Split-K over pages for the absorbed-MLA paged decode kernel.

The CUDA kernel cuts each slot's token axis into splits of
:data:`MLA_SPLIT` tokens.  One block serves one (split, group of 16
heads, slot) and keeps an online softmax ``(m, l, acc)`` over its split's
visible tokens: ``m`` the running max of the scaled scores, ``l = Σ exp(s
- m)`` and ``acc = Σ exp(s - m) · c``.  The split count comes from shapes
alone, ``ceil(M · bs / MLA_SPLIT)``, so the wrapper never reads a length
back to the host.  A slot whose visible tokens all lie in split 0 is
written directly by that split's block; otherwise the splits up to the
one holding token ``length - 1`` write partials to scratch (a split of
holes writes ``m = NEG_INF, l = 0, acc = 0``) and a second kernel merges
them in split order by the log-sum-exp rule of :func:`merge_partials`.

This module mirrors that arithmetic in Python for the tests; the main
path runs none of the plain functions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.split import (merge_partials,
                                                       num_splits,
                                                       partial_softmax,
                                                       scratch_bytes,
                                                       scratch_shapes)
from repro_torch.models.attention import assemble_shard_tables

#: tokens per split (8 tiles of 32)
MLA_SPLIT = 256


def last_split(length: int, split: int, nsplit: int) -> int:
    """The last split a slot of ``length`` tokens touches (0 when it sees
    nothing: split 0 writes its zeros); the slot needs the merge iff this
    is not 0."""
    return min((int(length) - 1) // split, nsplit - 1) if length > 0 else 0


def mla_partials_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     c_pool: torch.Tensor, rope_pool: torch.Tensor,
                     tables: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float, split: int = MLA_SPLIT):
    """Per-split states of the MLA kernel.  Arguments as
    ``ref.mla_paged_ctx_ref`` → ``m``, ``l``: (nsplit, B, H) and ``acc``:
    (nsplit, B, H, rank), the tokens of split j being positions ``[j *
    split, (j + 1) * split)``; a split that sees nothing has ``m =
    NEG_INF``, ``l = 0`` and ``acc = 0``."""
    B = q_lat.shape[0]
    N, bs, rank = c_pool.shape
    mono = assemble_shard_tables(tables)[:B]
    M = mono.shape[1]
    rows = mono.clamp(min=0).long()
    c = c_pool[rows].reshape(B, M * bs, rank).float()
    kr = rope_pool[rows].reshape(B, M * bs, rope_pool.shape[-1]).float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c)
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), kr)) * scale
    pos = torch.arange(M * bs, device=q_lat.device)
    visible = ((pos[None, :] < lengths.to(q_lat.device)[:, None])
               & (mono.repeat_interleave(bs, dim=1) >= 0))[:, None, :]
    ms, ls, accs = [], [], []
    for j in range(num_splits(M * bs, split)):
        vis = (visible & (pos // split == j)).expand_as(s)
        m, l, acc = partial_softmax(s, vis, c[:, None])
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


__all__ = ["MLA_SPLIT", "last_split", "mla_partials_ref", "merge_partials",
           "num_splits", "scratch_bytes", "scratch_shapes"]
