"""Plain PyTorch references of the served models, one module a family.

Each module's ``logits(params, config, tokens, first, quant=None)`` runs
one whole sequence through a full forward pass in float32 (TF32 off),
from the weights the benchmark made, and returns the logits of positions
``first ..`` (f32, (n, vocab)).  ``quant="fp8"`` rounds every weight
product's two operands to float8 e4m3 first (one scale a row of the
activations and a column of the weights): the lower-precision control.
They import nothing of the port.
"""

from __future__ import annotations

import contextlib

import torch

ATTN_BLOCK = 512            # query rows an attention block


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32 (no TF32) for the duration."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale a slice along ``dim``
    (the absmax maps to 448), back in f32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def mm(a: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """a (..., K) f32 @ w (K, N) (any float dtype) in f32."""
    w = w.float()
    if quant == "fp8":
        a, w = fp8(a, -1), fp8(w, -2)
    return a @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half layout: x (S, heads, d) at positions
    0 .. S-1."""
    S, d = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, scale: float) -> torch.Tensor:
    """q (S, H, d), k (S, H, d), v (S, H, dv) f32 → (S, H, dv), causal,
    in blocks of query rows."""
    S = q.shape[0]
    out = []
    for i in range(0, S, ATTN_BLOCK):
        j = min(S, i + ATTN_BLOCK)
        s = torch.einsum("qhd,khd->hqk", q[i:j], k[:j]) * scale
        mask = (torch.arange(i, j, device=q.device)[:, None]
                >= torch.arange(j, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[:j]))
    return torch.cat(out)


def swiglu(h, w_gate, w_up, w_down, quant=None):
    g = mm(h, w_gate, quant)
    return mm(torch.nn.functional.silu(g) * mm(h, w_up, quant), w_down, quant)


def layers(params: dict):
    """The layers' params in order (the port's layout: the unrolled
    prefix, then the periodic body, ``body[j][b]`` being layer
    ``prefix + b * period + j``)."""
    prefix, body = params["prefix"], params["body"]
    out = list(prefix)
    for b in range(len(body[0]) if body else 0):
        out.extend(body[j][b] for j in range(len(body)))
    return out
