"""Plain reference of a dense decoder with grouped-query attention
(granite-3-8b as the port serves it): pre-norm residual blocks, RMSNorm,
rotary embeddings on every head dim, causal softmax attention at scale
1/sqrt(head_dim), SwiGLU FFN, final RMSNorm, logits against the
(tied) embedding.  Departures from the published Granite model are
listed in the configuration file's ``assumed``."""

from __future__ import annotations

import torch

from perfbench.reference import (causal_attention, exact_f32, layers, mm,
                                 rms_norm, rope, swiglu)


def logits(params: dict, config: dict, tokens: torch.Tensor, first: int,
           quant=None) -> torch.Tensor:
    H, KV = config["num_attention_heads"], config["num_key_value_heads"]
    hd, eps = config["head_dim"], config["rms_norm_eps"]
    theta = config["rope_theta"]
    S = tokens.shape[0]
    with exact_f32(), torch.no_grad():
        x = params["embed"][tokens].float()
        for lp in layers(params):
            a, f = lp["mix"], lp["ffn"]
            h = rms_norm(x, a["norm"], eps)
            q = rope(mm(h, a["wq"], quant).reshape(S, H, hd), theta)
            k = rope(mm(h, a["wk"], quant).reshape(S, KV, hd), theta)
            v = mm(h, a["wv"], quant).reshape(S, KV, hd)
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
            o = causal_attention(q, k, v, hd ** -0.5)
            x = x + mm(o.reshape(S, H * hd), a["wo"], quant)
            h = rms_norm(x, f["norm"], eps)
            x = x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"], quant)
        h = rms_norm(x[first:], params["final_norm"], eps)
        table = params["embed"] if config["tie_word_embeddings"] \
            else params["unembed"]
        return mm(h, table.T, quant)
