"""Public flash-attention op: the reference's layout and padding shim over
the kernel.

Counterpart of ``repro.kernels.flash_attention.ops``.
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_fwd


def _pick_block(s: int, pref: int = 128) -> int:
    """Largest power-of-two tile ≤ pref that keeps padding overhead < 2×."""
    b = pref
    while b > 8 and s < b:
        b //= 2
    return b


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) → (B, Sq, H, hd).

    The model layout is (B, S, H, hd); the kernel takes heads-major
    (B, H, S, hd).  The sequences are zero-padded to multiples of
    :func:`_pick_block`, as the reference pads for its TPU tiles;
    ``sk_valid`` keeps the padded keys unseen."""
    Sq, Sk = q.shape[1], k.shape[1]
    pq, pk = (-Sq) % _pick_block(Sq), (-Sk) % _pick_block(Sk)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if pq:
        qt = F.pad(qt, (0, 0, 0, pq))
    if pk:
        kt, vt = F.pad(kt, (0, 0, 0, pk)), F.pad(vt, (0, 0, 0, pk))
    o = flash_attention_fwd(qt.contiguous(), kt.contiguous(),
                            vt.contiguous(), causal=causal, window=window,
                            q_offset=q_offset, sk_valid=Sk)
    return o[:, :, :Sq].transpose(1, 2)


__all__ = ["flash_attention"]
