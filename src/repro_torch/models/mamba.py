"""Mamba (S6 selective scan) mixer: Jamba's 7-in-8 layer.

PyTorch counterpart of ``repro.models.mamba``.  ``mamba_mix`` scans the
sequence one of three ways (``impl``):

  * ``"chunked"``: chunks of ``chunk`` steps, each scanned in parallel
    (a Hillis–Steele doubling scan in place of ``lax.associative_scan``),
    the state carried from chunk to chunk, each chunk checkpointed
    (:func:`~repro_torch.models.layers.remat`) as in the reference;
  * ``"sequential"``: the recurrence step by step (the oracle, and decode;
    the kernel's plain version);
  * ``"kernel"``: the CUDA kernel in ``kernels/mamba_scan`` (its plain
    version on the CPU).

Decode is the O(1) recurrent step carrying (conv_state, ssm_state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.models.layers import init_dense, remat, rms_norm

IMPLS = ("chunked", "sequential", "kernel")


def dt_rank(cfg) -> int:
    return max(16, cfg.d_model // 16)


def init_mamba(cfg, *, generator: torch.Generator, device,
               dtype=torch.bfloat16) -> dict:
    mm = cfg.mamba
    D, DI = cfg.d_model, cfg.d_inner
    R = dt_rank(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)
    A = torch.arange(1, mm.d_state + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(DI, 1)
    conv_w = torch.randn(mm.d_conv, DI, generator=generator, device=device,
                         dtype=torch.float32) * 0.1
    return {
        "norm": torch.ones(D, device=device, dtype=dtype),
        "in_proj": init_dense(D, 2 * DI, **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(DI, device=device, dtype=dtype),
        "x_proj": init_dense(DI, R + 2 * mm.d_state, **kw),
        "dt_proj": init_dense(R, DI, **kw),
        "A_log": torch.log(A),                    # f32: recurrence stability
        "D": torch.ones(DI, device=device, dtype=torch.float32),
        "out_proj": init_dense(DI, D, **kw),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  u: (B, S, DI), w: (K, DI) → (y, new_state),
    the state carrying the last K−1 inputs for decode continuity.  The sum
    runs in the reference's order."""
    K, S = w.shape[0], u.shape[1]
    if state is None:
        pad = u.new_zeros(u.shape[0], K - 1, u.shape[2])
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)                 # (B, S+K-1, DI)
    y = ext[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + ext[:, i:i + S] * w[i]
    return y + b, ext[:, ext.shape[1] - (K - 1):]


def _ssm_chunk_scan(dA: torch.Tensor, dBu: torch.Tensor, h0: torch.Tensor):
    """h_t = dA_t * h_{t-1} + dBu_t over axis 1 (the chunk), given h0.

    dA, dBu: (B, T, DI, N) f32.  The pairs compose with the reference's
    operator ``(a1, b1)∘(a2, b2) = (a1·a2, a2·b1 + b2)``, scanned by
    doubling: after the pass with shift s each step holds the composition
    of the 2s steps ending there.  Returns (h_all (B, T, DI, N), h_last).
    """
    a, b = dA, dBu
    T = a.shape[1]
    s = 1
    while s < T:
        a, b = (torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1),
                torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]],
                          dim=1))
        s *= 2
    h_all = a * h0[:, None] + b
    return h_all, h_all[:, -1]


def _chunk_step(h, dtk, Bk, Ck, xk, A):
    dA = torch.exp(dtk[..., None] * A[None, None])             # (B,T,DI,N)
    dBu = dtk[..., None] * Bk[:, :, None, :] * xk[..., None]
    h_all, h = _ssm_chunk_scan(dA, dBu, h)
    return h, torch.einsum("btdn,btn->btd", h_all, Ck)


def _scan_chunked(dt, A, Bf, Cf, xf, h0, chunk):
    S = dt.shape[1]
    pad = (-S) % chunk
    if pad:
        dt, Bf, Cf, xf = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bf, Cf, xf))
    h = h0
    ys = []
    for c0 in range(0, dt.shape[1], chunk):
        # checkpointed, as in the reference: the backward recomputes the
        # chunk's (B, T, DI, N) dA, dBu and h_all instead of keeping them
        h, y = remat(_chunk_step, h,
                     *(t[:, c0:c0 + chunk] for t in (dt, Bf, Cf, xf)), A)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba_mix(params: dict, u: torch.Tensor, cfg, *, chunk: int = 64,
              conv_state=None, ssm_state=None, impl: str = "chunked",
              tp=None):
    """Core mixer on pre-normed input u: (B, S, D) → (y, (conv_state,
    ssm_state)).  ``impl`` ∈ :data:`IMPLS`.

    Under ``tp`` (``distributed.parallel.TensorParallel``) rank i runs
    channels ``[i·DI/n, (i+1)·DI/n)``: u passes ``tp.copy_in``;
    ``in_proj`` comes whole (its stored ``model`` block is a contiguous
    share of the ``[x | z]`` columns, not the rank's x and z) and passes
    ``tp.copy_in`` before the rank's x and z columns are cut, as do
    ``conv_w``, ``conv_b``, ``A_log``, ``D`` and ``x_proj``'s rows;
    ``dt_proj``'s columns and ``out_proj``'s rows are the rank's blocks.
    The rank's rows of ``x_proj`` give a partial (delta, B, C), summed
    over ``model`` (``tp.reduce_product``), then passed through
    ``tp.copy_in``, so their channel-partial gradients are summed too;
    the output is summed the same way, and the states are the rank's
    channels'.

    Serving's decode passes ``in_proj`` as the rank's stored block
    instead (``D × 2·DI/n``, ``Layout.in_proj_exchange``): the rank
    multiplies u by it and all-gathers the (B, S, 2·DI/n) outputs over
    ``model`` (``tp.gather``, no gradient), then cuts its x and z
    columns: a step's few tokens move far fewer bytes than the leaf.
    The leaf's width says which it got."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    mm = cfg.mamba
    B = u.shape[0]
    DI, N = cfg.d_inner, mm.d_state
    R = dt_rank(cfg)
    p = params
    if tp is None:
        x, z = (u @ p["in_proj"]).chunk(2, dim=-1)
    else:
        p = dict(params, **{k: tp.cut(params[k], d) for k, d in (
            ("conv_w", 1), ("conv_b", 0), ("A_log", 0), ("D", 0),
            ("x_proj", 0))})
        lo, DI = tp.index * DI // tp.size, DI // tp.size
        u = tp.copy_in(u)
        if p["in_proj"].shape[-1] == 2 * cfg.d_inner:
            w = tp.copy_in(p["in_proj"])
            x, z = (u @ w[:, c:c + DI] for c in (lo, cfg.d_inner + lo))
        else:                           # the stored block: exchange outputs
            xz = tp.gather(u @ p["in_proj"], -1)
            x, z = (xz[..., c:c + DI] for c in (lo, cfg.d_inner + lo))
    x, conv_state = _causal_conv(x, p["conv_w"], p["conv_b"], conv_state)
    x = F.silu(x)
    if tp is None:
        proj = x @ p["x_proj"]
    else:
        proj = tp.copy_in(tp.reduce_product(x, p["x_proj"]))
    delta, Bc, Cc = proj.split([R, N, N], dim=-1)
    dt = F.softplus((delta @ p["dt_proj"]).float())
    A = -torch.exp(p["A_log"])                       # (DI, N)
    xf, Bf, Cf = x.float(), Bc.float(), Cc.float()
    h0 = (torch.zeros(B, DI, N, dtype=torch.float32, device=u.device)
          if ssm_state is None else ssm_state)

    if impl == "kernel":
        from repro_torch.kernels.mamba_scan import ops as ms_ops
        y_ssm, h_last = ms_ops.mamba_scan(dt, A, Bf, Cf, xf, h0)
    elif impl == "sequential":
        y_ssm, h_last = mamba_scan_ref(dt, A, Bf, Cf, xf, h0)
    else:
        y_ssm, h_last = _scan_chunked(dt, A, Bf, Cf, xf, h0, chunk)

    y = y_ssm + p["D"] * xf
    y = (y * F.silu(z.float())).to(u.dtype)
    out = (y @ p["out_proj"] if tp is None
           else tp.reduce_product(y, p["out_proj"]))
    return out, (conv_state, h_last)


def mamba_layer(params: dict, x: torch.Tensor, cfg, *,
                impl: str = "chunked", tp=None) -> torch.Tensor:
    """Pre-norm residual Mamba block; ``tp`` as :func:`mamba_mix`."""
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    y, _ = mamba_mix(params, h, cfg, impl=impl, tp=tp)
    return x + y


def mamba_decode_step(params: dict, x: torch.Tensor, cfg, conv_state,
                      ssm_state, tp=None):
    """x: (B, D) single token → (y (B, D), new states).  O(1) per step.
    Under ``tp`` (as :func:`mamba_mix`) the states are the rank's
    ``d_inner/|model|`` channels'."""
    h = rms_norm(x[:, None], params["norm"], cfg.norm_eps)
    y, (cs, ss) = mamba_mix(params, h, cfg, conv_state=conv_state,
                            ssm_state=ssm_state, impl="sequential", tp=tp)
    return x + y[:, 0], (cs, ss)


def init_mamba_state(cfg, batch: int, *, device="cuda",
                     dtype=torch.bfloat16):
    mm = cfg.mamba
    return (torch.zeros(batch, mm.d_conv - 1, cfg.d_inner, device=device,
                        dtype=dtype),
            torch.zeros(batch, cfg.d_inner, mm.d_state, device=device,
                        dtype=torch.float32))
