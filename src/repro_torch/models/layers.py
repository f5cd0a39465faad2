"""Shared building blocks: norms, rotary embeddings, FFNs, initializers.

PyTorch counterpart of ``repro.models.layers``: the same functions on
tensors, with the same layouts.  Initializers take an explicit
``torch.Generator``, ``device`` and ``dtype``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def dense_ffn(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = rms_norm(x, params["norm"], eps)
    return x + swiglu(h, params["w_gate"], params["w_up"], params["w_down"])


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
