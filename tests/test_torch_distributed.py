"""The port's serving on a device mesh against the JAX reference on the CPU:
the SP paged decode and MLA decode, the vocab-parallel embed, the SP
prefill write, ``decode_step``/``prefill`` on a mesh and elastic
checkpoint resharding, each on four gloo ranks of a (data 2, model 2)
mesh, held to the contract and tolerance ``tests/_distributed_checks.py``
holds the reference's to.

The module fixture makes the inputs from NumPy seeds and the
reference's single-device answers (``paged_decode_attention_ref``,
``mla_decode_ref``, ``jnp.take`` and ``jax.grad``, the single-device
write, ``decode_step(page_impl="ref")``), has the reference write a
checkpoint from a (4, 2) mesh of fake devices (a subprocess), and starts
the four ranks of ``tests/_torch_dist_ranks.py`` once (no JAX there),
rendezvousing through a file under ``tmp_path`` and bounded by a
timeout; each test reads its check's result.  f32: 2e-5 on attention
(the shards sum in another order), 1e-6 on the embed, 1e-5 on logits,
bit-exact writes and checkpoints.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import deepseek_moe_16b as jdsm  # noqa: E402
from repro.configs import deepseek_v2_236b as jdsv2  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JCfg  # noqa: E402
from repro.training.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from _torch_dist_ranks import spawn  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
#: a tiny attention-only decoder with tied embeddings (as granite-3-8b)
#: and an odd vocabulary (the vocab-parallel embed's short last shard)
TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=61, head_dim=16, tie_embeddings=True)
NEW_TOKENS = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ the inputs
def _sp_cases() -> dict:
    """The reference check's GQA case on a (2, 2) mesh: batch rows draw
    their blocks from their data shard's pool partition, one hole."""
    rng = np.random.RandomState(0)
    B, H, KV, hd, bs, M, N = 4, 4, 2, 32, 16, 6, 32
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(N, bs, KV, hd).astype(np.float32)
    vp = rng.randn(N, bs, KV, hd).astype(np.float32)
    part = N // 2                                 # rows per data shard
    tab = np.stack([(b // 2) * part + rng.permutation(part)[:M]
                    for b in range(B)]).astype(np.int32)
    tab[1, 5] = -1                                # hole
    lengths = np.asarray([M * bs - 3, 70, 1, 40], np.int32)
    ident = np.asarray(jtfm.sp_identity_tables(B, M, N, batch_shards=2,
                                               seq_shards=2))
    layouts = {"batch": (("data",), ("model",)),
               "seq": ((), ("data", "model"))}
    cases = {}
    for name, lay, tables, opt, window in (
            ("batch", "batch", tab, False, None),
            ("seq", "seq", tab, False, None),
            ("sp_opt", "batch", ident, True, None),
            ("batch_window", "batch", tab, False, 20),
            ("seq_window", "seq", tab, False, 33)):
        want = jattn.paged_decode_attention_ref(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lengths), window=window)
        ba, sa = layouts[lay]
        cases[name] = dict(q=q, kp=kp, vp=vp, tables=tables, lengths=lengths,
                           window=window, ba=ba, sa=sa, opt=opt,
                           want=np.asarray(want))
    return cases


def _mla_cases() -> dict:
    cfg = jdsv2.smoke()
    rng = np.random.RandomState(1)
    B, bs, M, N = 4, 16, 4, 16
    m = cfg.mla
    params = _np(jmla.init_mla(jax.random.PRNGKey(3), cfg, jnp.float32))
    x = rng.randn(B, cfg.d_model).astype(np.float32)
    positions = np.asarray([59, 32, 0, 16], np.int32)
    lengths = positions + 1
    c_pool = rng.randn(N, bs, m.kv_lora_rank).astype(np.float32)
    rope_pool = rng.randn(N, bs, m.rope_head_dim).astype(np.float32)
    part = N // 2
    tab = np.stack([(b // 2) * part + rng.permutation(part)[:M]
                    for b in range(B)]).astype(np.int32)
    tab[0, 2] = -1                                # hole
    ident = np.asarray(jtfm.sp_identity_tables(B, M, N, batch_shards=2,
                                               seq_shards=2))
    out = {"params": params}
    for name, tables, opt in (("sp", tab, False), ("sp_opt", ident, True)):
        want = jmla.mla_decode_ref(
            params, jnp.asarray(x), jnp.asarray(positions),
            jnp.asarray(c_pool), jnp.asarray(rope_pool), jnp.asarray(tables),
            jnp.asarray(lengths), cfg)
        out[name] = dict(x=x, positions=positions, lengths=lengths,
                         c_pool=c_pool, rope_pool=rope_pool, tables=tables,
                         opt=opt, want=np.asarray(want))
    return out


def _vocab_case() -> dict:
    V, D = 51, 16                                 # V % 2 != 0 (pad path)
    table = jax.random.normal(jax.random.PRNGKey(1), (V, D), jnp.float32)
    toks = jnp.asarray([[0, 1, 49, 17], [33, 2, 5, 48],
                        [50, 50, 0, 3], [7, 9, 11, 13]], jnp.int32)
    grad = jax.grad(lambda w: (jnp.take(w, toks, axis=0) ** 2).sum())(table)
    return dict(table=np.asarray(table), tokens=np.asarray(toks),
                want=np.asarray(jnp.take(table, toks, axis=0)),
                grad=np.asarray(grad))


def _scatter_cases() -> dict:
    """Prefill rows into a (2, 2)-sharded fused pool: with the batch over
    "data" each data shard's rows target its own pool partition; holes
    drop.  The answer is the single-device write."""
    rng = np.random.RandomState(2)
    N, bs, R = 16, 8, 8
    pool = rng.randn(N, bs, 4, 4).astype(np.float32)
    seq = rng.randn(R, bs, 4, 4).astype(np.float32)
    tab = np.concatenate([rng.permutation(N // 2)[:R // 2],
                          N // 2 + rng.permutation(N // 2)[:R // 2]])
    tab = tab.astype(np.int32)
    tab[[1, 6]] = -1
    neg = jnp.where(tab >= 0, tab, N)
    want = np.asarray(jnp.asarray(pool).at[neg].set(jnp.asarray(seq),
                                                     mode="drop"))
    return {name: dict(pool=pool, seq=seq, tab=tab, want=want, ba=ba, sa=sa)
            for name, ba, sa in (("batch", ("data",), ("model",)),
                                 ("seq", (), ("data", "model")))}


_jprefill = jax.jit(jtfm.prefill, static_argnums=1,
                    static_argnames=("moe_groups",))
_jdecode = jax.jit(jtfm.decode_step, static_argnums=1)


def _reference_run(cfg, B: int, moe_groups: int = 1) -> dict:
    """prefill (its MoE layers in ``moe_groups`` groups) + NEW_TOKENS
    greedy ``decode_step(page_impl="ref")`` of the reference over the
    (batch × seq)-sharded block layout that ``sharding.decode_axes``
    picks on (2, 2) for batch ``B``."""
    params = jtfm.init_params(jax.random.PRNGKey(5), cfg, jnp.float32)
    prompt = np.random.RandomState(6).randint(
        1, cfg.vocab, (B, 300)).astype(np.int32)
    shards = (2, 2) if B == 2 else (1, 4)
    max_len = 512
    st = jtfm.init_decode_state(cfg, B, max_len, dtype=jnp.float32,
                                batch_shards=shards[0],
                                seq_shards=shards[1])
    logits, st = _jprefill(params, cfg, jnp.asarray(prompt), st,
                           moe_groups=moe_groups)
    out = [np.asarray(logits)]
    for _ in range(NEW_TOKENS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, st = _jdecode(params, cfg, st, tok)
        out.append(np.asarray(logits))
    return dict(params=_np(params), prompt=prompt, max_len=max_len,
                logits=np.stack(out), moe_groups=moe_groups)


def _decode_cases() -> dict:
    """The MoE configs' cases run their MoE layers expert-parallel over
    the mesh's model dim (2 ranks: 4 of the 8 experts each)."""
    runs = {("tiny", 2): _reference_run(JCfg(**TINY), 2),
            ("tiny", 1): _reference_run(JCfg(**TINY), 1),
            ("deepseek-v2-smoke", 2): _reference_run(jdsv2.smoke(), 2),
            ("deepseek-moe-smoke", 2): _reference_run(jdsm.smoke(), 2,
                                                      moe_groups=2)}
    cases = {}
    for name, cfg, B, impl in (
            ("tiny_sp", "tiny", 2, "sp"),
            ("tiny_sp_opt", "tiny", 2, "sp_opt"),
            ("tiny_batch1_sp_opt", "tiny", 1, "sp_opt"),
            ("deepseek_v2_sp", "deepseek-v2-smoke", 2, "sp"),
            ("deepseek_v2_sp_opt", "deepseek-v2-smoke", 2, "sp_opt"),
            ("deepseek_moe_groups2_sp", "deepseek-moe-smoke", 2, "sp")):
        cases[name] = dict(runs[cfg, B], impl=impl,
                           cfg=TINY if cfg == "tiny" else cfg)
    return cases


def _loss_case() -> dict:
    """The tiny tied model's loss and its embedding's gradient (the table
    feeds both the lookup and the tied unembedding)."""
    cfg = JCfg(**TINY)
    params = jtfm.init_params(jax.random.PRNGKey(7), cfg, jnp.float32)
    toks = np.random.RandomState(8).randint(0, cfg.vocab, (2, 32))
    batch = {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(np.roll(toks, -1, 1), jnp.int32)}
    loss, grads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, cfg, batch))(params)
    return dict(params=_np(params), batch=_np(batch), loss=float(loss),
                grad=np.asarray(grads["embed"]))


_REF_CKPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import mesh_axis_kwargs
from repro.training.checkpoint import CheckpointManager
mesh = jax.make_mesh((4, 2), ("data", "model"), **mesh_axis_kwargs(2))
w = np.arange(64, dtype=np.float32).reshape(8, 8) * 0.5
b = np.arange(8, dtype=np.float32) - 3
tree = {"w": jax.device_put(w, NamedSharding(mesh, P("data", "model"))),
        "b": jax.device_put(b, NamedSharding(mesh, P("model")))}
assert len(tree["w"].addressable_shards) == 8
CheckpointManager(sys.argv[1]).save(1, tree)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", _REF_CKPT,
                          str(work / "ref_ckpt")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr
    inp = dict(sp=_sp_cases(), mla=_mla_cases(), vocab=_vocab_case(),
               scatter=_scatter_cases(), decode=_decode_cases(),
               expert_blocks=("deepseek_v2_sp", "deepseek_moe_groups2_sp"),
               loss=_loss_case(),
               elastic_ref={"w": np.arange(64, dtype=np.float32).reshape(
                   8, 8) * 0.5, "b": np.arange(8, dtype=np.float32) - 3})
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    results = []
    for r, (code, log) in enumerate(spawn(work, WORLD)):
        assert code == 0, f"rank {r} exited {code}:\n{log}"
        with open(work / f"result_{r}.json") as f:
            results.append(json.load(f))
    return work, inp, results


def _passed(results, name):
    for r, res in enumerate(results):
        assert name in res, f"rank {r} ran no check {name!r}"
        assert res[name]["ok"], f"rank {r}, {name}:\n{res[name]['error']}"
    return [res[name]["value"] for res in results]


def test_a_split_over_two_mesh_dims_is_row_major(ranks):
    _passed(ranks[2], "placement_order")


@pytest.mark.parametrize("case", ["batch", "seq", "sp_opt", "batch_window",
                                  "seq_window"])
def test_sp_paged_decode_matches_reference(ranks, case):
    _passed(ranks[2], f"sp_decode/{case}")


@pytest.mark.parametrize("case", ["sp", "sp_opt"])
def test_mla_decode_sp_matches_reference(ranks, case):
    _passed(ranks[2], f"mla_sp/{case}")


def test_vocab_parallel_embed_value_and_grad_match_reference(ranks):
    _passed(ranks[2], "vocab_embed")


@pytest.mark.parametrize("case", ["batch", "seq"])
def test_scatter_seq_sp_equals_single_device_write(ranks, case):
    _passed(ranks[2], f"scatter/{case}")


@pytest.mark.parametrize("case", ["tiny_sp", "tiny_sp_opt",
                                  "tiny_batch1_sp_opt", "deepseek_v2_sp",
                                  "deepseek_v2_sp_opt",
                                  "deepseek_moe_groups2_sp"])
def test_decode_step_on_a_mesh_matches_reference(ranks, case):
    """prefill(mesh=) writes the pools the SP decode then reads: greedy
    tokens equal, logits within 1e-5, and every rank the same logits.
    The MoE layers run expert-parallel; DeepSeek-MoE's prefill routes 2
    groups, as the reference's ``prefill(..., moe_groups=2)``."""
    digests = _passed(ranks[2], f"decode/{case}")
    assert len(set(digests)) == 1, digests


@pytest.mark.parametrize("case", ["deepseek_v2_sp",
                                  "deepseek_moe_groups2_sp"])
def test_serving_from_expert_blocks_equals_whole_stacks(ranks, case):
    """Each rank serving from its expert blocks alone
    (``sharding.expert_shards``: E/2 experts a layer, contiguous copies)
    gives the logits of the whole stacks bit for bit."""
    _passed(ranks[2], f"expert_blocks/{case}")


def test_loss_fn_on_a_mesh_matches_reference(ranks):
    """``loss_fn(mesh=)`` through the vocab-parallel embed: the loss and
    the gradient of each rank's rows of the tied embedding within 1e-5 of
    ``jax.value_and_grad``."""
    _passed(ranks[2], "loss")


def test_elastic_reshard_round_trips_across_meshes(ranks):
    """The port's (2, 2) checkpoint restores onto (1, 4) and (4, 1) and
    the reference's (4, 2) one onto (2, 2), bit-exact (the ranks); the
    reference's ``restore_host`` reads the port's checkpoint."""
    _passed(ranks[2], "elastic")
    flat, step = JCkpt(str(ranks[0] / "ckpt")).restore_host(1)
    assert step == 1
    np.testing.assert_array_equal(flat["w"], np.arange(64.0).reshape(8, 8))
    np.testing.assert_array_equal(flat["b"], np.arange(8.0))
    with open(ranks[0] / "ckpt" / "step_1" / "manifest.json") as f:
        shards = json.load(f)["leaves"]["w"]["shards"]
    assert sorted(shards) == [[[r, r + 4], [c, c + 4]] for r in (0, 4)
                              for c in (0, 4)]
