"""Plain PyTorch versions of the absorbed-MLA paged decode.

``mla_paged_ctx_ref`` has the exact semantics of the CUDA kernel in
``csrc/mla_attention.cu`` (and of the TPU kernel it replaces): the latent
context of every (slot, head) over the slot's resident pages, and 0 for
a slot that sees no token.  The kernel wrapper runs it for tensors on
the CPU, and the kernel is held against it on the card.
``mla_decode_ref`` is the model-level gather oracle, re-exported.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, assemble_shard_tables
from repro_torch.models.mla import mla_decode_ref


def mla_paged_ctx_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_pool: torch.Tensor, rope_pool: torch.Tensor,
                      tables: torch.Tensor, lengths: torch.Tensor, *,
                      scale: float) -> torch.Tensor:
    """q_lat: (B, H, rank); q_rope: (B, H, rope_hd); c_pool: (N, bs, rank);
    rope_pool: (N, bs, rope_hd); tables: (B, M) or the (W, Bs, M) shard
    stack, int32 (<0 = hole); lengths: (B,) → ctx (B, H, rank) f32.

    Token t of slot b is visible iff t < lengths[b] and its page is
    resident; ``ctx[h] = Σ p_t·c_t / max(Σ p_t, 1e-30)`` with
    ``s_t = (q_lat[h]·c_t + q_rope[h]·kr_t)·scale``.
    """
    B = q_lat.shape[0]
    N, bs, rank = c_pool.shape
    mono = assemble_shard_tables(tables)[:B]
    M = mono.shape[1]
    rows = mono.clamp(min=0).long()
    c = c_pool[rows].reshape(B, M * bs, rank).float()
    kr = rope_pool[rows].reshape(B, M * bs, rope_pool.shape[-1]).float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c)
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), kr)) * scale
    pos = torch.arange(M * bs, device=q_lat.device)[None, :]
    valid = ((pos < lengths.to(q_lat.device)[:, None])
             & (mono.repeat_interleave(bs, dim=1) >= 0))[:, None, :]
    s = torch.where(valid, s, NEG_INF)
    # masked scores underflow to 0 next to a visible one; the mask also
    # zeroes a slot with nothing visible, whose scores are all NEG_INF
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    return (torch.einsum("bhs,bsr->bhr", p, c)
            / p.sum(dim=-1, keepdim=True).clamp(min=1e-30))


__all__ = ["mla_paged_ctx_ref", "mla_decode_ref"]
