"""RWKV-6 "Finch" time-mix: attention-free mixer with data-dependent decay.

PyTorch counterpart of ``repro.models.rwkv6``.  The state per head is a
(head_dim × head_dim) outer-product accumulator:

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t          (w_t data-dependent, <1)
    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

``rwkv6_mix`` runs the recurrence one of three ways (``impl``):
``"chunked"`` (state carried across chunks, each chunk in direct form,
as the reference), ``"sequential"`` (step by step: the oracle, decode,
and the kernel's plain version) or ``"kernel"`` (the CUDA kernel in
``kernels/rwkv6_scan``; its plain version on the CPU).  No KV cache
exists: decode carries (last_x, wkv_state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense, remat, rms_norm

HEAD_SIZE = 64
IMPLS = ("chunked", "sequential", "kernel")


def init_rwkv6(cfg, *, generator: torch.Generator, device,
               dtype=torch.bfloat16) -> dict:
    D = cfg.d_model
    nH = D // HEAD_SIZE
    kw = dict(generator=generator, device=device, dtype=dtype)
    f32 = dict(generator=generator, device=device, dtype=torch.float32)
    return {
        "norm": torch.ones(D, device=device, dtype=dtype),
        "mu": torch.rand(5, D, **f32).to(dtype),
        "w_lora_a": init_dense(D, 64, **kw),
        "w_lora_b": (torch.randn(64, D, **f32) * 0.01).to(dtype),
        "wr": init_dense(D, D, **kw),
        "wk": init_dense(D, D, **kw),
        "wv": init_dense(D, D, **kw),
        "wg": init_dense(D, D, **kw),
        "u": torch.randn(nH, HEAD_SIZE, **f32) * 0.1,      # f32
        "ln_x": torch.stack([torch.ones(D, device=device),
                             torch.zeros(D, device=device)]),  # f32
        "wo": init_dense(D, D, **kw),
    }


def _projections(params, x, x_prev, cfg, tp=None):
    """Token-shift mixing and the r/k/v/g/w projections.  x, x_prev:
    (B, S, D).

    Under ``tp`` (``distributed.parallel.TensorParallel``) ``wr``, ``wk``,
    ``wv`` and ``wg`` hold the rank's heads' columns and r, k, v, g, w
    are those heads' (``D/|model|`` wide).  The four mixes feeding those
    products are made from x, x_prev and ``mu`` passed through
    ``tp.copy_in`` (two activations summed in backward, not four mixes);
    the decay LoRA's mix reads them as they came and runs its first
    product whole on every rank, its hidden passing ``tp.copy_in``
    before ``w_lora_b``'s columns of the rank's heads (cut after
    ``tp.copy_in``)."""
    def mixes(x, x_prev, mu, rows):
        xf, xp, mu = x.float(), x_prev.float(), mu.float()
        return [(xf + mu[i] * (xp - xf)).to(x.dtype) for i in rows]

    mu, lora_b = params["mu"], params["w_lora_b"]
    if tp is None:
        mix = mixes(x, x_prev, mu, range(5))
    else:
        mix = mixes(*map(tp.copy_in, (x, x_prev, mu)), range(4)) + mixes(
            x, x_prev, mu, (4,))
        lora_b = tp.cut(lora_b, -1)
    r = mix[0] @ params["wr"]
    k = mix[1] @ params["wk"]
    v = mix[2] @ params["wv"]
    g = mix[3] @ params["wg"]
    # Finch: data-dependent per-channel decay via LoRA
    hidden = torch.tanh(mix[4] @ params["w_lora_a"])
    w_raw = (hidden if tp is None else tp.copy_in(hidden)) @ lora_b
    w = torch.exp(-torch.exp(-0.5 + w_raw.float()))           # (0, 1)
    return r, k, v, g, w


def _heads(t, nH):
    B, S, D = t.shape
    return t.reshape(B, S, nH, HEAD_SIZE)


def _wkv_sequential(r, k, v, w, u, S0):
    """Oracle recurrence.  r, k, v, w: (B, S, nH, hd) f32; S0:
    (B, nH, hd, hd) → (y (B, S, nH, hd), S_last)."""
    S = S0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,nH,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    y = torch.stack(ys, dim=1) if ys else r.new_zeros(r.shape)
    return y, S


def _wkv_chunk_step(St, rk, kk, vk, wk, u):
    chunk = rk.shape[1]
    tidx = torch.arange(chunk, device=rk.device)
    mask = (tidx[:, None] > tidx[None, :])[None, :, :, None, None]
    # decay products: W_t = prod_{s<=t} w_s within the chunk
    logw = torch.log(wk)
    cum = torch.cumsum(logw, dim=1)                          # inclusive
    Wincl = torch.exp(cum)
    Wexcl = torch.exp(cum - logw)                            # exclusive
    # the carried state's contribution: r_t · diag(Wexcl_t) S
    y_state = torch.einsum("bchk,bhkv->bchv", rk * Wexcl, St)
    # pairwise decay D[t, s] = Wexcl_t / Wincl_s (valid for s < t)
    ratio = Wexcl[:, :, None] / Wincl[:, None, :]            # (B,t,s,nH,hd)
    att = torch.einsum("bthk,btshk,bshk->btsh", rk, ratio * mask, kk)
    diag = torch.einsum("bthk,hk,bthk->bth", rk, u, kk)
    y_intra = (torch.einsum("btsh,bshv->bthv", att, vk)
               + diag[..., None] * vk)
    # carry: S' = diag(Wincl_last) S + sum_s (prod_{s<u<=last} w) k_s v_s
    tail = Wincl[:, -1:] / Wincl
    St = (Wincl[:, -1][..., None] * St
          + torch.einsum("bshk,bshv->bhkv", tail * kk, vk))
    return St, y_state + y_intra


def _wkv_chunked(r, k, v, w, u, S0, chunk=32):
    """Chunked WKV: state carried across chunks, each chunk in direct form
    (the reference's algorithm, including its ``k / Wincl`` division) and
    checkpointed, as in the reference: the backward recomputes the
    chunk's (B, c, c, nH, hd) pairwise decays instead of keeping them."""
    S = r.shape[1]
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    St = S0
    ys = []
    for c0 in range(0, r.shape[1], chunk):
        St, y = remat(_wkv_chunk_step, St,
                      *(t[:, c0:c0 + chunk] for t in (r, k, v, w)), u)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], St


def rwkv6_mix(params, u_in, cfg, *, x_prev=None, wkv_state=None,
              impl="chunked", tp=None):
    """Pre-normed input u_in: (B, S, D) → (y, (last_x, wkv_state)).
    ``impl`` ∈ :data:`IMPLS`.  Under ``tp`` the rank computes its
    ``nH/|model|`` heads (:func:`_projections`; ``u`` and ``ln_x`` cut
    to them after ``tp.copy_in``), ``wo`` is their row block, the
    partial output is summed by ``tp.reduce_product``, and the state is
    the rank's heads'."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    B, S, D = u_in.shape
    first = (u_in.new_zeros(B, 1, D) if x_prev is None
             else x_prev[:, None].to(u_in.dtype))
    x_prev_full = torch.cat([first, u_in[:, :-1]], dim=1)
    r, k, v, g, w = _projections(params, u_in, x_prev_full, cfg, tp)
    uu, ln_x = params["u"], params["ln_x"]
    if tp is not None:
        uu, ln_x = tp.cut(uu, 0), tp.cut(ln_x, 1)
    Dl = r.shape[-1]
    nH = Dl // HEAD_SIZE
    rh = _heads(r, nH).float()
    kh = _heads(k, nH).float()
    vh = _heads(v, nH).float()
    # the reference rounds the decay through bf16 before any scan
    wh = _heads(w.to(torch.bfloat16), nH).float()
    S0 = (torch.zeros(B, nH, HEAD_SIZE, HEAD_SIZE, dtype=torch.float32,
                      device=u_in.device)
          if wkv_state is None else wkv_state)
    if impl == "kernel":
        from repro_torch.kernels.rwkv6_scan import ops as rk_ops
        y, S_last = rk_ops.rwkv6_scan(rh, kh, vh, wh, uu, S0)
    elif impl == "sequential":
        y, S_last = _wkv_sequential(rh, kh, vh, wh, uu, S0)
    else:
        y, S_last = _wkv_chunked(rh, kh, vh, wh, uu, S0)
    # per-head group norm
    scale, bias = ln_x[0], ln_x[1]
    yh = y.reshape(B, S, nH, HEAD_SIZE)
    mean = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, unbiased=False, keepdim=True)
    y = ((yh - mean) * torch.rsqrt(var + 1e-5)).reshape(B, S, Dl)
    y = y * scale + bias
    y = y * F.silu(g.float())
    y = y.to(u_in.dtype)
    out = (y @ params["wo"] if tp is None
           else tp.reduce_product(y, params["wo"]))
    return out, (u_in[:, -1], S_last)


def rwkv6_layer(params, x, cfg, *, impl="chunked", tp=None):
    """Pre-norm residual RWKV-6 time-mix; ``tp`` as :func:`rwkv6_mix`."""
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    y, _ = rwkv6_mix(params, h, cfg, impl=impl, tp=tp)
    return x + y


def rwkv6_decode_step(params, x, cfg, last_x, wkv_state, tp=None):
    """x: (B, D) → (y, (last_x, wkv_state)).  Under ``tp`` (as
    :func:`rwkv6_mix`) the rank steps its heads' (B, nH/|model|, 64, 64)
    state; ``last_x`` stays whole, as the token shift reads it whole."""
    h = rms_norm(x[:, None], params["norm"], cfg.norm_eps)
    y, (lx, st) = rwkv6_mix(params, h, cfg, x_prev=last_x,
                            wkv_state=wkv_state, impl="sequential", tp=tp)
    return x + y[:, 0], (lx, st)


def init_rwkv6_state(cfg, batch: int, *, device="cuda",
                     dtype=torch.bfloat16):
    nH = cfg.d_model // HEAD_SIZE
    return (torch.zeros(batch, cfg.d_model, device=device, dtype=dtype),
            torch.zeros(batch, nH, HEAD_SIZE, HEAD_SIZE, device=device,
                        dtype=torch.float32))
