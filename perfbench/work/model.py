"""The model's useful FLOPs, from the configuration file's published
widths: two a weight a token for every weight product (attention
projections, the FFN, the routed experts a token uses and the shared
ones, the router), attention over each token's real causal context
(QK^T and PV; MLA in its expanded form), and the LM head only for the
tokens that become an output, over the published vocabulary."""


def layer_params(c: dict, i: int) -> int:
    """Weights a token meets in layer ``i``."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    if "kv_lora_rank" in c:
        nope, rd, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                        c["v_head_dim"])
        rank, ql = c["kv_lora_rank"], c["q_lora_rank"]
        attn = (D * ql + ql * H * (nope + rd) + D * (rank + rd)
                + rank * H * (nope + vd) + H * vd * D)
        if i < c["first_k_dense_replace"]:
            return attn + 3 * D * c["intermediate_size"]
        de = c["moe_intermediate_size"]
        return (attn + D * c["n_routed_experts"]
                + 3 * D * de * (c["num_experts_per_tok"]
                                + c["n_shared_experts"]))
    KV, hd = c["num_key_value_heads"], c["head_dim"]
    return (2 * D * H * hd + 2 * D * KV * hd
            + 3 * D * c["intermediate_size"])


def token_flops(c: dict) -> float:
    """FLOPs of one token's weight products through every layer."""
    return 2.0 * sum(layer_params(c, i) for i in range(c["num_hidden_layers"]))


def attention_flops(c: dict, ctx_sum: float) -> float:
    """FLOPs of attention summed over tokens whose contexts sum to
    ``ctx_sum`` keys, through every layer."""
    H = c["num_attention_heads"]
    if "kv_lora_rank" in c:
        per = 2 * H * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) \
            + 2 * H * c["v_head_dim"]
    else:
        per = 4 * H * c["head_dim"]
    return float(per) * ctx_sum * c["num_hidden_layers"]


def head_flops(c: dict) -> float:
    return 2.0 * c["hidden_size"] * c["vocab_size"]
