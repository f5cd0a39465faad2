"""MoE routing groups on one device: the port's ``prefill``,
``decode_step``, ``prefill_chunk`` and ``ragged_step`` with
``moe_groups`` in {2, 3} against the reference's entry points with the
same groups, on the DeepSeek-MoE smoke config (layer 0 dense, layers 1-2
MoE).  Logits within 1e-5, the written KV pools within 2e-5 (the
tolerance of ``tests/test_torch_model.py``).  3 divides none of the
token counts, so the groups come down to 2 by the reference's ``while
T % G`` rule.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import deepseek_moe_16b as jdsm  # noqa: E402
from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.bridge import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.configs import deepseek_moe_16b as tdsm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
POOL_TOL = dict(rtol=2e-5, atol=2e-5)
BS = 128
SLOTS, M, N = 4, 4, 20
GROUPS = [2, 3]


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jdsm.smoke(), tdsm.smoke()
    jp = jtfm.init_params(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _state(cfg, rng, lengths):
    """Random pool contents, distinct blocks per slot, holes past each
    slot's length + 1."""
    spec = jtfm.cache_spec(cfg, SLOTS, M * BS, num_blocks=N,
                           dtype=jnp.float32)
    tables = rng.permutation(N)[:SLOTS * M].reshape(SLOTS, M)
    for b, n in enumerate(lengths):
        tables[b, n // BS + 1:] = -1
    st = {"kv": rng.randn(*spec["kv"][0]).astype(np.float32),
          "tables": tables.astype(np.int32),
          "lengths": np.asarray(lengths, np.int32)}
    return ({k: jnp.asarray(v) for k, v in st.items()},
            state_from_jax(st, device="cpu"))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **tol)


@pytest.mark.parametrize("G", GROUPS)
def test_prefill_moe_groups_match_reference(model, G):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(G)
    jst, tst = _state(jcfg, rng, [300, 300, 300, 300])
    toks = rng.randint(0, jcfg.vocab, (2, 200)).astype(np.int32)
    want, jnew = jtfm.prefill(jp, jcfg, jnp.asarray(toks), jst,
                              moe_groups=G)
    got, tnew = ttfm.prefill(tp, tcfg, torch.from_numpy(toks), tst,
                             moe_groups=G)
    _close(got, want, LOGIT_TOL)
    _close(tnew["kv"], jnew["kv"], POOL_TOL)


@pytest.mark.parametrize("G", GROUPS)
def test_decode_step_moe_groups_match_reference(model, G):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(10 + G)
    jst, tst = _state(jcfg, rng, [5, 200, 0, 383])
    toks = rng.randint(0, jcfg.vocab, SLOTS).astype(np.int32)
    want, jnew = jtfm.decode_step(jp, jcfg, jst, jnp.asarray(toks),
                                  moe_groups=G)
    got, tnew = ttfm.decode_step(tp, tcfg, tst, torch.from_numpy(toks),
                                 page_impl="ref", moe_groups=G)
    _close(got, want, LOGIT_TOL)
    _close(tnew["kv"], jnew["kv"], POOL_TOL)


@pytest.mark.parametrize("G", GROUPS)
def test_prefill_chunk_moe_groups_match_reference(model, G):
    """A chunk at a block-aligned offset in G groups, then the decode
    step that produces its logits."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(20 + G)
    jst, tst = _state(jcfg, rng, [400, 0, 0, 0])
    for st in (jst, tst):
        st["tables"], st["lengths"] = st["tables"][:1], st["lengths"][:1]
    toks = rng.randint(0, jcfg.vocab, (1, BS)).astype(np.int32)
    jnew = jtfm.prefill_chunk(jp, jcfg, jnp.asarray(toks), jst, 256,
                              moe_groups=G)
    tnew = ttfm.prefill_chunk(tp, tcfg, torch.from_numpy(toks), tst, 256,
                              moe_groups=G)
    _close(tnew["kv"], jnew["kv"], POOL_TOL)
    jnew["lengths"] = jnp.asarray([300], jnp.int32)
    tnew["lengths"] = torch.tensor([300], dtype=torch.int32)
    nxt = np.asarray([int(toks[0, 300 - 256 - 1])], np.int32)
    want, _ = jtfm.decode_step(jp, jcfg, jnew, jnp.asarray(nxt))
    got, _ = ttfm.decode_step(tp, tcfg, tnew, torch.from_numpy(nxt))
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("G", GROUPS)
def test_ragged_step_moe_groups_match_reference(model, G):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(30 + G)
    #       slot, q_len, q_start: a first chunk, a resumed chunk, a decode
    rows = [(0, 100, 0), (1, 60, 128), (2, 1, 310)]
    d = jops.build_ragged_descriptor(
        [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
        [r[1] + r[2] for r in rows], num_slots=SLOTS, t_cap=SLOTS * BS)
    toks = rng.randint(0, jcfg.vocab, SLOTS * BS).astype(np.int32)
    keys = ("token_row", "token_pos", "tile_row", "tile_pos", "kv_lens",
            "last_index")
    jst, tst = _state(jcfg, rng, [0, 128, 310, 0])
    want, jnew = jtfm.ragged_step(jp, jcfg, jst, jnp.asarray(toks),
                                  *(jnp.asarray(d[k]) for k in keys),
                                  moe_groups=G)
    got, tnew = ttfm.ragged_step(tp, tcfg, tst, torch.from_numpy(toks),
                                 *(torch.from_numpy(d[k]) for k in keys),
                                 moe_groups=G)
    live = torch.from_numpy(d["last_index"] >= 0)
    _close(got[live], np.asarray(want)[live.numpy()], LOGIT_TOL)
    _close(tnew["kv"], jnew["kv"], POOL_TOL)
