"""Public absorbed-MLA decode op: projections in PyTorch, the paged
softmax over latents in the CUDA kernel.

Counterpart of ``repro.kernels.mla_attention.ops``: a drop-in for
``models.mla.mla_decode_ref`` with the same signature and math.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mla_attention.mla_attention import mla_paged_ctx_fwd
from repro_torch.kernels.paged_attention.ops import shard_descriptor
from repro_torch.models.mla import absorbed_query, mla_out


def mla_paged_decode(params: dict, x: torch.Tensor, positions: torch.Tensor,
                     c_pool: torch.Tensor, rope_pool: torch.Tensor,
                     block_tables: torch.Tensor, lengths: torch.Tensor,
                     cfg) -> torch.Tensor:
    """x: (B, D) current-token activations → (B, D) with the residual.

    ``block_tables`` is the ``(B, M)`` table or the ``(W, Bs, M)`` shard
    stack; the kernel walks the stack directly."""
    m = cfg.mla
    q_lat, q_rope, w_uv = absorbed_query(params, x, positions, cfg)
    stack, _, _, _ = shard_descriptor(block_tables)
    ctx = mla_paged_ctx_fwd(
        q_lat.contiguous(), q_rope.contiguous(), c_pool, rope_pool, stack,
        lengths.to(torch.int32).contiguous(),
        scale=float((m.nope_head_dim + m.rope_head_dim) ** -0.5))
    return mla_out(params, x, ctx, w_uv)


__all__ = ["mla_paged_decode"]
