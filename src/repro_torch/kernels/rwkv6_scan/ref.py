"""Plain PyTorch versions of the RWKV-6 WKV recurrence.

``rwkv6_scan_ref(r, k, v, w, u, S0)`` is ``models.rwkv6._wkv_sequential``
(r, k, v, w: (B, S, nH, hd); u: (nH, hd); S0: (B, nH, hd, hd) →
(y, S_last), step by step), the function of the CUDA kernel in
``csrc/rwkv6_scan.cu`` and of the TPU kernel it replaces.  The kernel
wrapper runs it for tensors on the CPU, and the kernel is held against it
on the card.

``rwkv6_chunked_ref`` follows the kernel's schedule instead, for the
tests: chunks of :data:`CHUNK` tokens in direct form, the value columns
in ``col_split`` groups, and the sequential recurrence for a chunk whose
cumulated decay falls past ``threshold`` on some channel of the head.
The main path runs neither of them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.rwkv6 import _wkv_sequential as rwkv6_scan_ref

#: tokens a chunk of the kernel
CHUNK = 32
#: the kernel's direct form needs exp(-cum) finite: a chunk whose smallest
#: cumulated log decay over the head's channels is below -DECAY_LIMIT (or
#: not a number) runs the sequential recurrence (``DECAY_LIMIT`` in the .cu)
DECAY_LIMIT = 60.0


def fast_chunks(w, *, chunk: int = CHUNK,
                threshold: float = DECAY_LIMIT) -> torch.Tensor:
    """(B, nchunks, nH) bool: the chunks of each (b, head) that the
    kernel runs in direct form (smallest cumulated log decay over the
    head's channels at least ``-threshold``); the others take the
    sequential recurrence.  w: (B, S, nH, hd), padded with w = 1."""
    B, S, nH, hd = w.shape
    w = F.pad(w, (0, 0, 0, 0, 0, (-S) % chunk), value=1.0)
    cum_last = torch.log(w).reshape(B, -1, chunk, nH, hd).sum(dim=2)
    return cum_last.amin(dim=-1) >= -threshold


def rwkv6_chunked_ref(r, k, v, w, u, S0, *, chunk: int = CHUNK,
                      col_split: int = 1, threshold: float = DECAY_LIMIT):
    """The kernel's schedule in plain PyTorch; same arguments and result
    as :func:`rwkv6_scan_ref`.  Per chunk and channel, with ``cum`` the
    inclusive cumsum of ``log w`` over the chunk:
    ``y = (r e^{cum - log w}) S + (mask_strict((r e^{cum - log w})
    (k e^{-cum})ᵀ) + diag(Σ r u k)) v`` and ``S ← e^{cum_last} S +
    (k e^{cum_last - cum})ᵀ v``, over ``col_split`` groups of value
    columns.  A (b, head) whose chunk has ``min cum_last < -threshold``
    takes the sequential recurrence for that chunk.  The sequence is
    padded with ``w = 1``, ``r = k = v = 0``, which adds nothing."""
    B, S, nH, hd = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    vc = hd // col_split
    fast_all = fast_chunks(w, chunk=chunk, threshold=threshold)
    t_idx = torch.arange(chunk, device=r.device)
    strict = t_idx[:, None] > t_idx[None, :]
    eye = t_idx[:, None] == t_idx[None, :]
    St = S0
    ys = []
    for c0 in range(0, r.shape[1], chunk):
        rk, kk, vk, wk = (t[:, c0:c0 + chunk] for t in (r, k, v, w))
        logw = torch.log(wk)
        cum = torch.cumsum(logw, dim=1)
        last = cum[:, -1]                                     # (B, nH, hd)
        fast = fast_all[:, c0 // chunk]                       # (B, nH)
        rW = rk * torch.exp(cum - logw)
        kW = kk * torch.exp(-cum)
        kT = kk * torch.exp(last[:, None] - cum)
        a = torch.einsum("bthd,hd,bthd->bht", rk, u, kk)
        att = torch.einsum("bthd,bshd->bhts", rW, kW)
        att = torch.where(strict, att, 0.0) + torch.where(
            eye, a[..., None], 0.0)
        y_parts, s_parts = [], []
        for g in range(col_split):
            cols = slice(g * vc, (g + 1) * vc)
            Sg, vg = St[..., cols], vk[..., cols]
            y_parts.append(torch.einsum("bthd,bhdc->bthc", rW, Sg)
                           + torch.einsum("bhts,bshc->bthc", att, vg))
            s_parts.append(torch.exp(last)[..., None] * Sg
                           + torch.einsum("bshd,bshc->bhdc", kT, vg))
        y = torch.cat(y_parts, dim=-1)
        S_next = torch.cat(s_parts, dim=-1)
        if not bool(fast.all()):
            y_seq, s_seq = rwkv6_scan_ref(rk, kk, vk, wk, u, St)
            y = torch.where(fast[:, None, :, None], y, y_seq)
            S_next = torch.where(fast[..., None, None], S_next, s_seq)
        ys.append(y)
        St = S_next
    y = torch.cat(ys, dim=1) if ys else r.new_zeros(r.shape)
    return y[:, :S], St


__all__ = ["CHUNK", "DECAY_LIMIT", "fast_chunks", "rwkv6_scan_ref",
           "rwkv6_chunked_ref"]
