"""Plain reference of DeepSeek-V3 as one chip of an expert-parallel layer
serves it, for the CPU tests: plain ``torch`` in float32, one whole
sequence at a time, no kernel, cache or batching; it imports neither JAX
nor anything of the port.

Multi-head latent attention in expanded form (query LoRA, RMSNorm'd KV
latent, one rotary key shared by the heads, rotate-half rope at
``rope_theta``, softmax scale 1/sqrt(nope + rope)); SwiGLU FFNs, dense in
the first ``first_k_dense_replace`` layers; MoE after them with
DeepSeek-V3's router (:func:`gate`, transcribed from ``Gate.forward`` in
DeepSeek's ``inference/model.py``), every routed slot computed (no
capacity), but only for the ``n_routed_experts`` experts held here,
from ``deployment.held_first_expert`` on, plus the shared expert.
``spec`` is a dict of the configuration's keys (``perfbench/configs/
deepseek-v3-671b.json``'s names); the router's width is read from its
weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gate(x, weight, bias, n_groups: int, topk_groups: int, topk: int,
         route_scale: float):
    """``Gate.forward`` of DeepSeek-V3 (score_func "sigmoid", a bias,
    n_groups > 1), line for line; ``weight`` is (dim, n_experts) here,
    so ``linear(x, weight)`` is ``x @ weight``."""
    scores = x @ weight
    scores = scores.sigmoid()
    original_scores = scores
    scores = scores + bias
    scores = scores.view(x.size(0), n_groups, -1)
    group_scores = scores.topk(2, dim=-1)[0].sum(dim=-1)
    indices = group_scores.topk(topk_groups, dim=-1)[1]
    mask = scores.new_ones(x.size(0), n_groups, dtype=bool).scatter_(
        1, indices, False)
    scores = scores.masked_fill_(mask.unsqueeze(-1), float("-inf")).flatten(1)
    indices = torch.topk(scores, topk, dim=-1)[1]
    weights = original_scores.gather(1, indices)
    weights /= weights.sum(dim=-1, keepdim=True)
    weights *= route_scale
    return weights.type_as(x), indices


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (S, heads, d) at positions 0 .. S-1, rotate-half layout."""
    S, d = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = torch.arange(S, dtype=torch.float32)[:, None] * inv[None]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def swiglu(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def mla(p, x, spec):
    S = x.shape[0]
    H, eps = spec["num_attention_heads"], spec["rms_norm_eps"]
    nope, rd = spec["qk_nope_head_dim"], spec["qk_rope_head_dim"]
    vd, rank = spec["v_head_dim"], spec["kv_lora_rank"]
    h = rms_norm(x, p["norm"], eps)
    q = (rms_norm(h @ p["wq_a"], p["q_norm"], eps) @ p["wq_b"]).view(
        S, H, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], spec["rope_theta"])],
                  -1)
    kv_a = h @ p["wkv_a"]
    kv = (rms_norm(kv_a[:, :rank], p["kv_norm"], eps) @ p["wkv_b"]).view(
        S, H, nope + vd)
    k_rope = rope(kv_a[:, None, rank:], spec["rope_theta"]).expand(S, H, rd)
    k = torch.cat([kv[..., :nope], k_rope], -1)
    s = torch.einsum("qhd,khd->hqk", q, k) * (nope + rd) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    a = s.masked_fill(~causal, float("-inf")).softmax(-1)
    o = torch.einsum("hqk,khd->qhd", a, kv[..., nope:])
    return x + o.reshape(S, H * vd) @ p["wo"]


def moe(p, x, spec, first: int):
    """The MoE block of the experts ``[first, first + n_routed_experts)``
    (``p``'s expert stacks hold exactly those), dropless, the shared
    expert once."""
    h = rms_norm(x, p["norm"], spec["rms_norm_eps"])
    weights, indices = gate(h, p["router"], p["router_bias"],
                            spec["n_group"], spec["topk_group"],
                            spec["num_experts_per_tok"],
                            spec["routed_scaling_factor"])
    out = swiglu(h, p["s_gate"], p["s_up"], p["s_down"])
    for j in range(spec["n_routed_experts"]):
        rows, slot = (indices == first + j).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(h[rows], p["w_gate"][j], p["w_up"][j], p["w_down"][j])
            out = out.index_add(0, rows, y * weights[rows, slot, None])
    return x + out


def layer_list(params):
    """The layers in order: the unrolled prefix, then the body, whose
    ``body[j][b]`` is layer ``prefix + b * period + j``."""
    body = params["body"]
    out = list(params["prefix"])
    for b in range(len(body[0]) if body else 0):
        out += [body[j][b] for j in range(len(body))]
    return out


def f32(tree):
    if isinstance(tree, torch.Tensor):
        return tree.float()
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return [f32(v) for v in tree]


@torch.no_grad()
def logits(params, spec, tokens):
    """(S, vocab) f32 logits of one whole sequence ``tokens`` (S,), the
    held experts from ``spec["deployment"]["held_first_expert"]`` on."""
    params = f32(params)
    eps = spec["rms_norm_eps"]
    first = spec["deployment"]["held_first_expert"]
    x = params["embed"][tokens]
    for i, lp in enumerate(layer_list(params)):
        x = mla(lp["mix"], x, spec)
        f = lp["ffn"]
        if i < spec["first_k_dense_replace"]:
            x = x + swiglu(rms_norm(x, f["norm"], eps), f["w_gate"],
                           f["w_up"], f["w_down"])
        else:
            x = moe(f, x, spec, first)
    return rms_norm(x, params["final_norm"], eps) @ params["unembed"].T
