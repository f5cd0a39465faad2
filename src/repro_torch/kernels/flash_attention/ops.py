"""Public flash-attention op: the model's layout over the kernel.

Counterpart of ``repro.kernels.flash_attention.ops``.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_fwd


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) → (B, Sq, H, hd).

    The model layout is (B, S, H, hd) and the kernel's heads-major
    (B, H, S, hd): it reads transposed views of the model's tensors
    through their strides and writes the output in q's layout, so no
    transposed copy is made and the result's ``reshape(B, S, H * hd)`` is
    free.  The kernel tiles the sequences itself: the reference's padding
    to its TPU tiles (keys past ``sk_valid`` unseen) is not needed."""
    o = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            q_offset=q_offset)
    return o.transpose(1, 2)


__all__ = ["flash_attention"]
