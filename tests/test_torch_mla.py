"""Parity of the port's MLA and MoE slice against the JAX reference on the
CPU: ``models.moe`` (routing, capacity drops, the residual block),
``models.mla`` (latents, the expanded layer, the absorbed gather oracle),
the plain version and the CPU path of the absorbed-MLA paged decode
kernel against the Pallas kernel in interpret mode, and ``prefill`` +
``decode_step`` of the DeepSeek-V2 smoke config.  Parameters are made on
the reference side and bridged; inputs come from a NumPy seed.  f32
throughout: 2e-5 (the two sides sum in other orders), 1e-4 absolute on
matmul outputs of large magnitude, 1e-4 on logits."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes, several test workers: one intra-op thread each keeps the
# workers from oversubscribing the cores
torch.set_num_threads(1)

from repro.configs import deepseek_moe_16b as jdsm  # noqa: E402
from repro.configs import deepseek_v2_236b as jdsv2  # noqa: E402
from repro.kernels.mla_attention import mla_attention as jmk  # noqa: E402
from repro.kernels.mla_attention import ops as jmops  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.bridge import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.configs import deepseek_moe_16b as tdsm  # noqa: E402
from repro_torch.configs import deepseek_v2_236b as tdsv2  # noqa: E402
from repro_torch.kernels.mla_attention import mla_attention as tmk  # noqa: E402
from repro_torch.kernels.mla_attention import ops as tmops  # noqa: E402
from repro_torch.kernels.mla_attention import ref as tmref  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from _torch_cases import MLA, mla_case, rand, shard_stack, tables  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
MATMUL_TOL = dict(rtol=2e-5, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BS = 128

CONFIGS = {"deepseek-v2": (jdsv2.smoke, tdsv2.smoke),
           "deepseek-moe": (jdsm.smoke, tdsm.smoke)}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jmake, tmake = CONFIGS[request.param]
    jcfg, tcfg = jmake(), tmake()
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _jlayer(jp, cfg, i):
    """The reference's parameters of layer ``i`` (unstacked from the scan)."""
    prefix, period = cfg.segmentation()
    if i < prefix:
        return jp["prefix"][i]
    b, j = divmod(i - prefix, period)
    return jax.tree.map(lambda a: a[b], jp["body"][j])


def _moe_layer(cfg):
    return cfg.ffns.index("moe")


# -------------------------------------------------------------------- MoE
@pytest.mark.parametrize("overflow", [False, True],
                         ids=["within-capacity", "overflow"])
def test_moe_ffn_matches_reference(model, overflow):
    jcfg, tcfg, jp, tp = model
    i = _moe_layer(jcfg)
    jffn = dict(_jlayer(jp, jcfg, i)["ffn"])
    tffn = dict(ttfm.layer_params(tp, tcfg, i)["ffn"])
    rng = np.random.RandomState(1)
    x = rand(rng, 2, 45, jcfg.d_model)
    if overflow:
        # a common direction in every token and a router column along it:
        # every token picks expert 0, far past its capacity
        x += 3.0
        router = np.array(jffn["router"])
        router[:, 0] = 0.5
        jffn["router"], tffn["router"] = jnp.asarray(router), t(router)
    h = rms_norm(t(x), tffn["norm"], tcfg.norm_eps).reshape(
        -1, tcfg.d_model)
    _, eidx, _ = tmoe._route(tffn["router"], h, tcfg.moe.top_k)
    cap = tmoe.capacity_for(h.shape[0], tcfg.moe.top_k,
                            tcfg.moe.num_experts)
    assert (int(torch.bincount(eidx.reshape(-1)).max()) > cap) == overflow
    want, want_aux = jmoe.moe_ffn(jffn, x, jcfg)
    got, got_aux = tmoe.moe_ffn(tffn, t(x), tcfg)
    close(got, want, **MATMUL_TOL)
    close(got_aux, want_aux)


def test_moe_routing_matches_reference_with_ties():
    """Experts 1 and 2 score identically for every token: the reference's
    top_k takes the lower index first, and so must the port."""
    rng = np.random.RandomState(2)
    x = rand(rng, 40, 16)
    router = rand(rng, 16, 8)
    router[:, 2] = router[:, 1]
    jg, je, ja = jmoe._route(jnp.asarray(router), x, 3)
    tg, te, ta = tmoe._route(t(router), t(x), 3)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    close(tg, jg)
    close(ta, ja)
    for n in (1, 7, 100, 4096):
        assert tmoe.capacity_for(n, 6, 160) == jmoe.capacity_for(n, 6, 160)


# -------------------------------------------------------------------- MLA
@pytest.fixture(scope="module")
def dsv2():
    jcfg, tcfg = jdsv2.smoke(), tdsv2.smoke()
    jp = jtfm.init_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, _jlayer(jp, jcfg, 1)["mix"], \
        ttfm.layer_params(tp, tcfg, 1)["mix"]


def test_latent_kv_and_mla_layer_match_reference(dsv2):
    jcfg, tcfg, jlp, tlp = dsv2
    rng = np.random.RandomState(4)
    x = rand(rng, 2, 150, jcfg.d_model)
    pos = np.broadcast_to(np.arange(150, dtype=np.int32)[None], (2, 150))
    h = rand(rng, 2, 150, jcfg.d_model)
    wc, wr = jmla.latent_kv(jlp, h, jcfg, pos)
    gc, gr = tmla.latent_kv(tlp, t(h), tcfg, t(pos))
    close(gc, wc)
    close(gr, wr, **MATMUL_TOL)
    close(tmla.mla_layer(tlp, t(x), t(pos), tcfg),
          jmla.mla_layer(jlp, x, pos, jcfg), **MATMUL_TOL)
    wk, wv = jmla.absorbed_weights(jlp, jcfg)
    gk, gv = tmla.absorbed_weights(tlp, tcfg)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _decode_inputs(jcfg, seed, B=4, M=3):
    m = jcfg.mla
    rng = np.random.RandomState(seed)
    N = B * M + 2
    mono, _ = tables(rng, B, M, N, 1)
    mono[0, 1] = -1
    lengths = rng.randint(1, M * BS + 1, B).astype(np.int32)
    return dict(x=rand(rng, B, jcfg.d_model),
                pos=(lengths - 1).astype(np.int32),
                c=rand(rng, N, BS, m.kv_lora_rank),
                kr=rand(rng, N, BS, m.rope_head_dim), mono=mono,
                lengths=lengths)


def test_mla_decode_ref_matches_reference(dsv2):
    jcfg, tcfg, jlp, tlp = dsv2
    d = _decode_inputs(jcfg, 5)
    want = jmla.mla_decode_ref(jlp, d["x"], d["pos"], d["c"], d["kr"],
                               d["mono"], d["lengths"], jcfg)
    got = tmla.mla_decode_ref(tlp, t(d["x"]), t(d["pos"]), t(d["c"]),
                              t(d["kr"]), t(d["mono"]), t(d["lengths"]),
                              tcfg)
    close(got, want, **MATMUL_TOL)


@pytest.mark.parametrize("case", MLA, ids=str)
def test_mla_paged_ctx_matches_pallas_interpret(case):
    c = mla_case(6, **case)
    args = (c["q_lat"], c["q_rope"], c["c"], c["kr"], c["stack"],
            c["lengths"])
    want = jmk.mla_paged_ctx_fwd(*(jnp.asarray(a) for a in args),
                                 scale=c["scale"], interpret=True)
    plain = tmref.mla_paged_ctx_ref(*map(t, args), scale=c["scale"])
    close(plain, want)
    # the CPU path of the kernel wrapper is the plain version
    np.testing.assert_array_equal(
        tmk.mla_paged_ctx_fwd(*map(t, args), scale=c["scale"]).numpy(),
        plain.numpy())
    seen_nothing = (c["mono"] < 0).all(1) | (c["lengths"] == 0)
    assert seen_nothing.sum() == 2
    assert not plain[t(seen_nothing)].any()


@pytest.mark.parametrize("W", [1, 2, 4])
def test_mla_paged_decode_matches_reference(dsv2, W):
    jcfg, tcfg, jlp, tlp = dsv2
    d = _decode_inputs(jcfg, 7 + W)
    stack = shard_stack(d["mono"], W)
    args = (d["x"], d["pos"], d["c"], d["kr"], stack, d["lengths"])
    want = jmops.mla_paged_decode(jlp, *(jnp.asarray(a) for a in args),
                                  jcfg, interpret=True)
    got = tmops.mla_paged_decode(tlp, *map(t, args), tcfg)
    close(got, want, **MATMUL_TOL)
    # every slot sees a token, so the gather oracle agrees too
    close(got, tmla.mla_decode_ref(tlp, t(d["x"]), t(d["pos"]), t(d["c"]),
                                   t(d["kr"]), t(d["mono"]),
                                   t(d["lengths"]), tcfg), **MATMUL_TOL)


# ------------------------------------------------------------ the slice
SLOTS, M, N = 4, 3, 16


def test_decode_state_layout_matches_reference():
    jcfg, tcfg = jdsv2.smoke(), tdsv2.smoke()
    jspec = jtfm.cache_spec(jcfg, 6, 700, num_blocks=50, round_to=4)
    tspec = ttfm.cache_spec(tcfg, 6, 700, num_blocks=50, round_to=4)
    assert {k: v[0] for k, v in jspec.items()} == \
        {k: v[0] for k, v in tspec.items()}
    assert "mla_c" in tspec and "kv" not in tspec
    jst = jtfm.init_decode_state(jcfg, 4, 512, num_blocks=20,
                                 dtype=jnp.float32, batch_shards=2)
    tst = ttfm.init_decode_state(tcfg, 4, 512, num_blocks=20,
                                 batch_shards=2, device="cpu")
    for k in jst:
        np.testing.assert_array_equal(tst[k], np.asarray(jst[k]))


@pytest.mark.parametrize("W,impl", [(1, "ref"), (1, "kernel"), (2, "kernel"),
                                    (4, "kernel")])
def test_prefill_and_greedy_decode_match_reference(W, impl):
    """DeepSeek-V2 smoke: prefill every slot (MLA latents into the pools,
    dense layer 0, MoE after), then greedy decode through the paged
    latents: logits within 1e-4, pools within 2e-5, tokens identical."""
    jcfg, tcfg = jdsv2.smoke(), tdsv2.smoke()
    jp = jtfm.init_params(jax.random.PRNGKey(8), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(20 + W)
    prompt = rng.randint(1, jcfg.vocab, (SLOTS, 150)).astype(np.int32)
    mono = np.arange(SLOTS * M, dtype=np.int32).reshape(SLOTS, M)
    spec = jtfm.cache_spec(jcfg, SLOTS, M * BS, N, jnp.float32)
    st = {k: np.zeros(spec[k][0], np.float32) for k in ("mla_c", "mla_rope")}
    st.update(tables=shard_stack(mono, W), lengths=np.zeros(SLOTS, np.int32))
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = state_from_jax(st, device="cpu")
    jlg, jst = jtfm.prefill(jp, jcfg, jnp.asarray(prompt), jst)
    tlg, tst = ttfm.prefill(tp, tcfg, t(prompt), tst)
    close(tlg, jlg, **LOGIT_TOL)
    for k in ("mla_c", "mla_rope"):
        close(tst[k], jst[k], **MATMUL_TOL)
    jt = np.asarray(jlg).argmax(-1).astype(np.int32)
    tt = tlg.argmax(-1).to(torch.int32)
    jtoks, ttoks = [jt], [tt.numpy()]
    for _ in range(4):
        jlg, jst = jtfm.decode_step(jp, jcfg, jst, jnp.asarray(jt))
        tlg, tst = ttfm.decode_step(tp, tcfg, tst, tt, page_impl=impl)
        close(tlg, jlg, **LOGIT_TOL)
        jt = np.asarray(jlg).argmax(-1).astype(np.int32)
        tt = tlg.argmax(-1).to(torch.int32)
        jtoks.append(jt)
        ttoks.append(tt.numpy())
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
    for k in ("mla_c", "mla_rope"):
        close(tst[k], jst[k], **MATMUL_TOL)
    np.testing.assert_array_equal(tst["lengths"], np.asarray(jst["lengths"]))


def test_chunked_and_ragged_paths_refuse_mla():
    cfg = tdsv2.smoke()
    toks = torch.zeros(BS, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="attention-mixer"):
        ttfm.prefill_chunk({}, cfg, toks[None], {}, 0)
    with pytest.raises(NotImplementedError, match="attention-mixer"):
        ttfm.ragged_step({}, cfg, {}, toks, *[toks] * 6)
