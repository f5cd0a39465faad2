"""Plain reference of DeepSeek-V3 as one chip of an expert-parallel layer
serves it: the latent attention of ``mla_moe`` (expanded form), a dense
SwiGLU FFN in the first ``first_k_dense_replace`` layers and a mixture
of experts after, routed as DeepSeek-V3's ``Gate`` routes (sigmoid
scores in f32 over every expert, the router's width read from its
weight; a correction bias; each of ``n_group`` groups scored by the sum
of its two best corrected scores, the best ``topk_group`` searched for
the top ``num_experts_per_tok``; their uncorrected scores renormalised,
times ``routed_scaling_factor``), every routed slot computed (no
capacity) but only for the ``n_routed_experts`` experts held here, from
``deployment.held_first_expert`` on, plus the shared expert.  What the
experts held elsewhere would add is left out, as the program leaves it
out.  Departures from the published model are listed in the
configuration file's ``assumed``."""

from __future__ import annotations

import torch

from perfbench.reference import exact_f32, layers, mm, rms_norm, swiglu
from perfbench.reference.mla_moe import _mla


def route(h, router, bias, config: dict):
    """(gates (T, k) f32, experts (T, k)) of the tokens h (T, D) f32."""
    s = torch.sigmoid(h @ router.float())
    T, G = s.shape[0], config["n_group"]
    c = (s + bias.float()).view(T, G, -1)
    groups = c.topk(2, dim=-1).values.sum(-1).topk(
        config["topk_group"], dim=-1).indices
    out = torch.ones(T, G, dtype=torch.bool, device=h.device)
    out[torch.arange(T, device=h.device)[:, None], groups] = False
    c = c.masked_fill(out[..., None], float("-inf")).view(T, -1)
    experts = c.topk(config["num_experts_per_tok"], dim=-1).indices
    gates = s.gather(1, experts)
    gates = gates / gates.sum(-1, keepdim=True)
    return gates * config["routed_scaling_factor"], experts


def _moe(f: dict, x, config: dict, quant):
    h = rms_norm(x, f["norm"], config["rms_norm_eps"])
    gates, experts = route(h, f["router"], f["router_bias"], config)
    first = config["deployment"]["held_first_expert"]
    out = swiglu(h, f["s_gate"], f["s_up"], f["s_down"], quant)
    for e in torch.unique(experts).tolist():
        j = e - first
        if not 0 <= j < config["n_routed_experts"]:
            continue
        rows, slot = (experts == e).nonzero(as_tuple=True)
        y = swiglu(h[rows], f["w_gate"][j], f["w_up"][j], f["w_down"][j],
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
