"""Shared building blocks: norms, rotary embeddings, FFNs, initializers.

PyTorch counterpart of ``repro.models.layers``: the same functions on
tensors, with the same layouts.  Initializers take an explicit
``torch.Generator``, ``device`` and ``dtype``.  :func:`remat` is the
counterpart of ``jax.checkpoint``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def init_dense(d_in: int, d_out: int, *, generator: torch.Generator,
               device, dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.randn(d_in, d_out, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


# ----------------------------------------------------------------- rotary ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., :, None].float() * freqs           # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- FFNs ----
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def init_swiglu(d_model: int, d_ff: int, *, generator: torch.Generator,
                device, dtype=torch.bfloat16) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {"w_gate": init_dense(d_model, d_ff, **kw),
            "w_up": init_dense(d_model, d_ff, **kw),
            "w_down": init_dense(d_ff, d_model, **kw)}


def dense_ffn(params: dict, x: torch.Tensor, eps: float,
              tp=None) -> torch.Tensor:
    """Pre-norm residual SwiGLU.  With ``tp`` the gate and up columns and
    the down rows are this rank's blocks: the normed input passes
    ``tp.copy_in``, the partial output ``tp.reduce_out``."""
    h = rms_norm(x, params["norm"], eps)
    if tp is not None:
        h = tp.copy_in(h)
    out = swiglu(h, params["w_gate"], params["w_up"], params["w_down"])
    return x + (out if tp is None else tp.reduce_out(out))


# ------------------------------------------------------------- embeddings ----
def init_embed(vocab: int, d_model: int, *, generator: torch.Generator,
               device, dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.randn(vocab, d_model, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in f32 (loss stability)."""
    return x.float() @ table.float().T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -100) -> torch.Tensor:
    """Mean negative log-likelihood over the labels that are not
    ``ignore_id``."""
    mask = labels != ignore_id
    labels = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1)


# ------------------------------------------------------------ cache writes ----
class DropIndex(NamedTuple):
    """Where a write of fixed length lands (:func:`drop_index`): each
    index with the dropped entries sent to the sink cell, the kept
    entries (R,), the first kept entry (1,) (0 when none is), whether
    any is kept, and the sink cell ((1,) each)."""
    index: tuple
    keep: torch.Tensor
    first: torch.Tensor | None
    any_kept: torch.Tensor | None
    sink: tuple


def drop_index(index: tuple, keep: torch.Tensor) -> DropIndex:
    """The cells of a write of fixed length, computed once for every pool
    written at the same places.

    index: a tuple of (R,) integer tensors into the leading dims of a
    pool (a dropped entry's may hold anything: a hole, padding, a row
    past the pool); keep: (R,) bool.  Every dropped entry is sent to the
    first kept entry's cell, or to cell 0 when none is kept."""
    if keep.numel() == 0:
        return DropIndex(tuple(i.long() for i in index), keep, None, None, ())
    any_kept = keep.any()
    first = keep.to(torch.uint8).argmax().reshape(1)   # 0 when none is
    sink = tuple(torch.where(any_kept, i.index_select(0, first).long(), 0)
                 for i in index)                       # (1,) each
    return DropIndex(tuple(torch.where(keep, i.long(), s)
                           for i, s in zip(index, sink)),
                     keep, first, any_kept, sink)


def drop_write(pool: torch.Tensor, where: DropIndex,
               values: torch.Tensor) -> torch.Tensor:
    """``pool[index] = values`` for the kept entries of ``where``
    (:func:`drop_index`), in place: the reference's
    ``.at[index].set(values, mode="drop")`` with shapes that do not
    depend on the data (no ``nonzero``, no host sync).  values: (R, ...).

    A dropped entry writes the first kept entry's value to that entry's
    cell, or, when none is kept, ``pool[0, ...]`` back to itself: each
    duplicate index carries the value already bound for its cell, so
    the result is that of the kept writes alone, whatever order the
    device applies them in."""
    if where.keep.numel() == 0:
        return pool
    values = values.to(pool.dtype)
    fill = torch.where(where.any_kept, values.index_select(0, where.first),
                       pool[where.sink])
    mask = where.keep.reshape((-1,) + (1,) * (values.dim() - 1))
    return pool.index_put_(where.index, torch.where(mask, values, fill))


# ------------------------------------------------------------------ remat ----
def remat(fn, *args):
    """``fn(*args)``, keeping only ``args`` for the backward, which runs
    ``fn`` again (``jax.checkpoint``); a plain call where autograd records
    nothing."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
