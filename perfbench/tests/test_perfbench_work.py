"""Each count of ``perfbench/work`` against a hand count at a small
shape."""

import numpy as np
import pytest

from perfbench.work import mla, model, paged_decode, ragged, resident_keys

DIMS = {"heads": 4, "kv_heads": 2, "head_dim": 8, "attn_layers": 3,
        "mla_layers": 0, "rank": 16, "rope": 4, "pool_bytes": 2,
        "act_bytes": 2, "block": 4, "table_cols": 3}


def test_resident_keys():
    t = np.array([[5, -1, 7]])
    assert resident_keys(t, 0, 10, 4) == 4 + 0 + 2
    assert resident_keys(t, 0, 3, 4) == 3
    assert resident_keys(t, 0, 0, 4) == 0


def test_paged_decode_work_by_hand():
    tables = np.array([[0, 1, -1], [-1, -1, -1], [2, -1, -1]])
    lengths = np.array([5, 0, 2])          # slot 0 sees 6 keys, slot 2 3
    f, b = paged_decode.work((tables, lengths), DIMS)
    keys = 6 + 3
    assert f == 4 * keys * 4 * 8
    assert b == keys * 2 * 2 * 8 * 2 + 2 * 2 * 4 * 8 * 2 + 2 * 4 * 4


def test_ragged_work_by_hand():
    # slot 1: a chunk at positions 4..6 (kv 7); slot 3: a decode row at 9
    desc = {"token_row": np.array([1, 1, 1, -1, 3, -1, -1, -1]),
            "token_pos": np.array([4, 5, 6, 0, 9, 0, 0, 0]),
            "kv_lens": np.array([1, 7, 1, 10])}
    f, b = ragged.work(desc, DIMS)
    pairs = 5 + 6 + 7 + 10
    assert f == 4 * pairs * 4 * 8
    assert b == ((7 + 10) * 2 * 2 * 8 * 2 + 2 * 4 * 4 * 8 * 2 + 4 * 2 * 4
                 + 2 * (3 + 1) * 4)


def test_mla_work_by_hand():
    d = dict(DIMS, mla_layers=2)
    tables = np.array([[3, 4, -1]])
    f, b = mla.work((tables, np.array([6])), d)    # 7 keys
    assert f == 7 * 4 * (2 * 20 + 2 * 16)
    assert b == 7 * 20 * 2 + 4 * (32 + 4) * 4 + 4 * 4


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_model_flops_by_hand(kind):
    if kind == "gqa":
        c = {"hidden_size": 8, "num_attention_heads": 2,
             "num_key_value_heads": 1, "head_dim": 4,
             "intermediate_size": 16, "num_hidden_layers": 2,
             "vocab_size": 10}
        per_layer = 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8 + 3 * 8 * 16
        attn = 4 * 2 * 4
    else:
        c = {"hidden_size": 8, "num_attention_heads": 2, "kv_lora_rank": 4,
             "q_lora_rank": 6, "qk_nope_head_dim": 3, "qk_rope_head_dim": 2,
             "v_head_dim": 3, "first_k_dense_replace": 1,
             "intermediate_size": 16, "moe_intermediate_size": 5,
             "n_routed_experts": 7, "num_experts_per_tok": 2,
             "n_shared_experts": 1, "num_hidden_layers": 2,
             "vocab_size": 10}
        mla_p = 8 * 6 + 6 * 2 * 5 + 8 * 6 + 4 * 2 * 6 + 2 * 3 * 8
        per_layer = (mla_p + 3 * 8 * 16 + mla_p + 8 * 7
                     + 3 * 8 * 5 * 3) / 2
        attn = 2 * 2 * 5 + 2 * 2 * 3
    assert model.token_flops(c) == 2 * 2 * per_layer
    assert model.attention_flops(c, 10) == attn * 10 * 2
    assert model.head_flops(c) == 2 * 8 * 10
