"""Plain reference of a DeepSeek-V2 decoder as the port serves it:
multi-head latent attention in its expanded form (query LoRA, RMSNorm'd
KV latent, one rotary key shared by the heads, softmax scale
1/sqrt(nope + rope)), a dense SwiGLU FFN in the first
``first_k_dense_replace`` layers and a mixture of experts after: softmax
router in f32, the top ``num_experts_per_tok`` experts by probability
with their gates renormalised to sum to one, every routed token computed
(no capacity), plus the shared experts.  Departures from the published
model are listed in the configuration file's ``assumed``."""

from __future__ import annotations

import torch

from perfbench.reference import (causal_attention, exact_f32, layers, mm,
                                 rms_norm, rope, swiglu)


def _mla(a: dict, x, config: dict, quant):
    S = x.shape[0]
    H, eps = config["num_attention_heads"], config["rms_norm_eps"]
    nope, rd = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    vd, rank = config["v_head_dim"], config["kv_lora_rank"]
    theta = config["rope_theta"]
    h = rms_norm(x, a["norm"], eps)
    q = mm(rms_norm(mm(h, a["wq_a"], quant), a["q_norm"], eps), a["wq_b"],
           quant).reshape(S, H, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    kv_a = mm(h, a["wkv_a"], quant)
    c = rms_norm(kv_a[:, :rank], a["kv_norm"], eps)
    k_rope = rope(kv_a[:, None, rank:], theta).expand(S, H, rd)
    kv = mm(c, a["wkv_b"], quant).reshape(S, H, nope + vd)
    k = torch.cat([kv[..., :nope], k_rope], dim=-1)
    o = causal_attention(q, k, kv[..., nope:], (nope + rd) ** -0.5)
    return x + mm(o.reshape(S, H * vd), a["wo"], quant)


def _moe(f: dict, x, config: dict, quant):
    h = rms_norm(x, f["norm"], config["rms_norm_eps"])
    k = config["num_experts_per_tok"]
    probs = torch.softmax(h @ f["router"].float(), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    out = swiglu(h, f["s_gate"], f["s_up"], f["s_down"], quant)
    for e in torch.unique(experts).tolist():
        rows, slot = (experts == e).nonzero(as_tuple=True)
        y = swiglu(h[rows], f["w_gate"][e], f["w_up"][e], f["w_down"][e],
                   quant)
        out.index_add_(0, rows, y * gates[rows, slot][:, None])
    return x + out


def logits(params: dict, config: dict, tokens: torch.Tensor, first: int,
           quant=None) -> torch.Tensor:
    eps = config["rms_norm_eps"]
    with exact_f32(), torch.no_grad():
        x = params["embed"][tokens].float()
        for i, lp in enumerate(layers(params)):
            x = _mla(lp["mix"], x, config, quant)
            f = lp["ffn"]
            if i < config["first_k_dense_replace"]:
                h = rms_norm(x, f["norm"], eps)
                x = x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"], quant)
            else:
                x = _moe(f, x, config, quant)
        h = rms_norm(x[first:], params["final_norm"], eps)
        return mm(h, params["unembed"].T, quant)
