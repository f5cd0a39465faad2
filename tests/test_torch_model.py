"""Slice-level parity of ``repro_torch.models.transformer`` against
``repro.models.transformer``: the logits of ``decode_step``, ``prefill``,
``ragged_step`` and (through the decode step after it) ``prefill_chunk``
agree within 1e-4, the written KV pools within 2e-5, and greedy decoding
gives identical tokens over W ∈ {1, 2, 4} table shards.  Parameters are
made on the reference side and bridged (no PRNG parity); the port runs
on the CPU, where ``page_impl="kernel"`` takes the kernels' plain
versions."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.configs import granite_3_8b as jgranite  # noqa: E402
from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JCfg  # noqa: E402
from repro_torch.bridge import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.configs import granite_3_8b as tgranite  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.config import ModelConfig as TCfg  # noqa: E402
from _torch_cases import shard_stack  # noqa: E402

#: the tiny serving config of tests/test_ragged_serving.py
_TINY = dict(name="t", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
             d_ff=64, vocab=64, head_dim=16)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=2e-5, atol=2e-5)
BS = 128
SLOTS, M, N = 4, 4, 20


@pytest.fixture(scope="module", params=["tiny", "granite-smoke"])
def model(request):
    if request.param == "tiny":
        jcfg, tcfg = JCfg(**_TINY), TCfg(**_TINY)
    else:
        jcfg, tcfg = jgranite.smoke(), tgranite.smoke()
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _state(cfg, rng, W, lengths):
    """Random pool contents, distinct blocks per slot, holes past each
    slot's length + 1; the (W, Bs, M) shard stack."""
    spec = jtfm.cache_spec(cfg, SLOTS, M * BS, num_blocks=N,
                           dtype=jnp.float32)
    mono = rng.permutation(N)[:SLOTS * M].reshape(SLOTS, M).astype(np.int32)
    for b, n in enumerate(lengths):
        mono[b, n // BS + 1:] = -1
    return {"kv": rng.randn(*spec["kv"][0]).astype(np.float32),
            "tables": shard_stack(mono, W),
            "lengths": np.asarray(lengths, np.int32)}


def _both(st):
    return ({k: jnp.asarray(v) for k, v in st.items()},
            state_from_jax(st, device="cpu"))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **tol)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_decode_step_matches_reference(model, W):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(W)
    jst, _ = _both(_state(jcfg, rng, W, [5, 200, 0, 383]))
    toks = rng.randint(0, jcfg.vocab, SLOTS).astype(np.int32)
    want, jnew = jtfm.decode_step(jp, jcfg, jst, jnp.asarray(toks))
    for impl in ("kernel", "ref"):
        _, tst = _both({k: np.asarray(v) for k, v in jst.items()})
        got, tnew = ttfm.decode_step(tp, tcfg, tst, torch.from_numpy(toks),
                                     page_impl=impl)
        _close(got, want, LOGIT_TOL)
        _close(tnew["kv"], jnew["kv"], POOL_TOL)
        np.testing.assert_array_equal(tnew["lengths"], jnew["lengths"])


@pytest.mark.parametrize("W", [1, 4])
def test_prefill_matches_reference(model, W):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(10 + W)
    st = _state(jcfg, rng, W, [300, 300, 300, 300])
    jst, tst = _both(st)
    toks = rng.randint(0, jcfg.vocab, (2, 200)).astype(np.int32)
    want, jnew = jtfm.prefill(jp, jcfg, jnp.asarray(toks), jst)
    got, tnew = ttfm.prefill(tp, tcfg, torch.from_numpy(toks), tst)
    _close(got, want, LOGIT_TOL)
    _close(tnew["kv"], jnew["kv"], POOL_TOL)
    np.testing.assert_array_equal(tnew["lengths"], jnew["lengths"])


def test_prefill_chunk_then_decode_matches_reference(model):
    """A chunk at a block-aligned offset, then the decode step that
    produces its logits (the engine's order)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(20)
    st = _state(jcfg, rng, 1, [400, 0, 0, 0])
    jst, tst = _both(st)
    jst["tables"], tst["tables"] = jst["tables"][0, :1], tst["tables"][0, :1]
    jst["lengths"], tst["lengths"] = jst["lengths"][:1], tst["lengths"][:1]
    toks = rng.randint(0, jcfg.vocab, (1, BS)).astype(np.int32)
    jnew = jtfm.prefill_chunk(jp, jcfg, jnp.asarray(toks), jst, 256)
    tnew = ttfm.prefill_chunk(tp, tcfg, torch.from_numpy(toks), tst, 256)
    _close(tnew["kv"], jnew["kv"], POOL_TOL)
    jnew["lengths"] = jnp.asarray([300], jnp.int32)
    tnew["lengths"] = torch.tensor([300], dtype=torch.int32)
    nxt = np.asarray([int(toks[0, 300 - 256 - 1])], np.int32)
    want, _ = jtfm.decode_step(jp, jcfg, jnew, jnp.asarray(nxt))
    got, _ = ttfm.decode_step(tp, tcfg, tnew, torch.from_numpy(nxt),
                              page_impl="kernel")
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_ragged_step_matches_reference(model, W):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(30 + W)
    st = _state(jcfg, rng, W, [0, 128, 310, 0])
    #       slot, q_len, q_start: a first chunk, a resumed chunk, a decode
    rows = [(0, 100, 0), (1, 60, 128), (2, 1, 310)]
    d = jops.build_ragged_descriptor(
        [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
        [r[1] + r[2] for r in rows], num_slots=SLOTS, t_cap=SLOTS * BS)
    toks = rng.randint(0, jcfg.vocab, SLOTS * BS).astype(np.int32)
    keys = ("token_row", "token_pos", "tile_row", "tile_pos", "kv_lens",
            "last_index")
    jst, _ = _both(st)
    want, jnew = jtfm.ragged_step(jp, jcfg, jst, jnp.asarray(toks),
                                  *(jnp.asarray(d[k]) for k in keys))
    live = d["last_index"] >= 0
    for impl in ("kernel", "ref"):
        _, tst = _both(st)
        got, tnew = ttfm.ragged_step(tp, tcfg, tst, torch.from_numpy(toks),
                                     *(torch.from_numpy(d[k]) for k in keys),
                                     page_impl=impl)
        _close(got[torch.from_numpy(live)], np.asarray(want)[live],
               LOGIT_TOL)
        _close(tnew["kv"], jnew["kv"], POOL_TOL)
        np.testing.assert_array_equal(tnew["lengths"], jnew["lengths"])


@pytest.mark.parametrize("W", [1, 2, 4])
def test_greedy_tokens_match_reference(model, W):
    """Prefill every slot, then greedy decode: identical tokens."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(40 + W)
    prompt = rng.randint(1, jcfg.vocab, (SLOTS, 150)).astype(np.int32)
    mono = np.arange(SLOTS * M, dtype=np.int32).reshape(SLOTS, M)
    st = {"kv": np.zeros(jtfm.cache_spec(jcfg, SLOTS, M * BS, N,
                                         jnp.float32)["kv"][0], np.float32),
          "tables": shard_stack(mono, W),
          "lengths": np.zeros(SLOTS, np.int32)}
    jst, tst = _both(st)
    jlg, jst = jtfm.prefill(jp, jcfg, jnp.asarray(prompt), jst)
    tlg, tst = ttfm.prefill(tp, tcfg, torch.from_numpy(prompt), tst)
    jt = np.asarray(jlg).argmax(-1).astype(np.int32)
    tt = tlg.argmax(-1).to(torch.int32)
    jtoks, ttoks = [jt], [tt.numpy()]
    for _ in range(5):
        jlg, jst = jtfm.decode_step(jp, jcfg, jst, jnp.asarray(jt))
        tlg, tst = ttfm.decode_step(tp, tcfg, tst, tt, page_impl="kernel")
        jt = np.asarray(jlg).argmax(-1).astype(np.int32)
        tt = tlg.argmax(-1).to(torch.int32)
        jtoks.append(jt)
        ttoks.append(tt.numpy())
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


def test_unsupported_models_raise():
    g = torch.Generator().manual_seed(0)
    for cfg in (TCfg(**_TINY, mixers=("mamba",)),
                TCfg(**_TINY, ffns=("moe",)),
                TCfg(**_TINY, enc_dec=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            ttfm.init_params(cfg, generator=g, device="cpu")


def test_decode_state_layout_matches_reference():
    jcfg, tcfg = JCfg(**_TINY), TCfg(**_TINY)
    jspec = jtfm.cache_spec(jcfg, 6, 700, num_blocks=50, round_to=4)
    tspec = ttfm.cache_spec(tcfg, 6, 700, num_blocks=50, round_to=4)
    assert {k: v[0] for k, v in jspec.items()} == \
        {k: v[0] for k, v in tspec.items()}
    for shards in ((1, 1), (2, 1), (2, 2)):
        np.testing.assert_array_equal(
            ttfm.sp_identity_tables(8, 6, 64, *shards, device="cpu"),
            jtfm.sp_identity_tables(8, 6, 64, *shards))
    jst = jtfm.init_decode_state(jcfg, 4, 512, dtype=jnp.float32)
    tst = ttfm.init_decode_state(tcfg, 4, 512, device="cpu")
    for k in jst:
        np.testing.assert_array_equal(tst[k], np.asarray(jst[k]))


@pytest.mark.parametrize("W", [1, 4])
def test_token_writes_drop_like_reference(W):
    """Holes drop the write (the reference maps them past the pool with
    mode="drop"); positions past the table clamp to its last column."""
    rng = np.random.RandomState(50 + W)
    mono = rng.permutation(N)[:SLOTS * M].reshape(SLOTS, M).astype(np.int32)
    mono[1, 2] = -1
    stack = shard_stack(mono, W)
    pool = rng.randn(2, N, BS, 2, 16).astype(np.float32)
    new = rng.randn(SLOTS, 2, 16).astype(np.float32)
    lengths = np.asarray([5, 300, 0, M * BS + 7], np.int32)
    want = jtfm._write_token_kv_stacked(jnp.asarray(pool), 1,
                                        jnp.asarray(stack), lengths, new, BS)
    got = ttfm._write_token_kv_stacked(torch.from_numpy(pool.copy()), 1,
                                       torch.from_numpy(stack),
                                       torch.from_numpy(lengths),
                                       torch.from_numpy(new), BS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
