"""Mixture-of-Experts FFN — DeepSeek-style shared + routed top-k experts.

PyTorch counterpart of ``repro.models.moe``, routing groups included;
on a mesh the groups are those of the global token stream (``dp`` in
:func:`moe_mix`).  Dispatch is the same sort-based, capacity-bounded
scheme, per group:

  1. top-k routing per token in f32, gates renormalised over the chosen k,
  2. flatten (token, k) slots and sort them stably by expert id,
  3. position-in-expert from segment arithmetic,
  4. add kept slots into an (E, C, D) buffer (dropped slots add 0),
  5. batched expert SwiGLU as ``torch.bmm`` over the expert dim,
  6. gather back through the inverse permutation, weight by gates, sum
     over k.

Expert parallelism (``ep`` in :func:`moe_mix`) is the eager counterpart
of the reference's ``_ep_constrain``, which pins the expert dim of
GSPMD's dispatch buffers to ``model``: a rank holds the ``E/|model|``
experts ``[i·E_l, (i+1)·E_l)`` of its ``model`` index ``i`` (and the
shared experts' column and row blocks), routes the whole group as every
rank does, fills and runs only its own ``(E_l, C, D)`` buffer, and the
ranks' partial outputs are summed over ``model``.  The ranks hold the
same activations, so no token moves between them: the one collective is
that SUM, as a tensor-parallel dense FFN issues it.

A :class:`~repro_torch.models.moe_config.GroupRoutedMoE` layer (the
port's alone: DeepSeek-V3) replaces step 1 by sigmoid, group-limited,
bias-corrected routing over ``routed_experts`` experts
(:func:`_route_grouped`) and holds only its ``num_experts`` of them,
``[held_first, held_first + num_experts)``: one chip's share of an
expert-parallel layer, run without the exchange.  It routes every token
over all the experts, computes its own experts' slots (capacity from the
routed-over count, as the mesh path has it) and the shared experts once;
what the other experts would add is left out.

Capacity drops make every token's output depend on the whole group, so
callers route exactly the token stream the reference routes, padding
included.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import recorder as trace_rec
from repro_torch.models.layers import init_dense, rms_norm
from repro_torch.models.moe_config import GroupRoutedMoE


def _init_experts(E: int, d_in: int, d_out: int, *, generator, device,
                  dtype) -> torch.Tensor:
    """(E, d_in, d_out) unit normals over sqrt(d_in), scaled in place (a
    full-size expert stack is gigabytes; no second copy is made)."""
    w = torch.randn(E, d_in, d_out, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def init_moe(cfg, *, generator: torch.Generator, device,
             dtype=torch.bfloat16) -> dict:
    mo = cfg.moe
    D = cfg.d_model
    de = mo.d_expert or cfg.d_ff
    E = mo.num_experts
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {"norm": torch.ones(D, device=device, dtype=dtype),
         # routing in f32 whatever the model dtype
         "router": init_dense(D, _routed(mo), generator=generator,
                              device=device, dtype=torch.float32)}
    if isinstance(mo, GroupRoutedMoE):
        # the correction bias, set by load statistics outside the gradient
        p["router_bias"] = torch.zeros(mo.routed_experts, device=device,
                                       dtype=torch.float32)
    p.update(w_gate=_init_experts(E, D, de, **kw),
             w_up=_init_experts(E, D, de, **kw),
             w_down=_init_experts(E, de, D, **kw))
    if mo.num_shared:
        ds = de * mo.num_shared
        p["s_gate"] = init_dense(D, ds, **kw)
        p["s_up"] = init_dense(D, ds, **kw)
        p["s_down"] = init_dense(ds, D, **kw)
    return p


def _routed(mo) -> int:
    """The experts the router scores (all of them, held here or not)."""
    return mo.routed_experts if isinstance(mo, GroupRoutedMoE) \
        else mo.num_experts


def capacity_for(tokens_per_group: int, top_k: int, num_experts: int,
                 capacity_factor: float = 1.25, min_capacity: int = 4) -> int:
    c = int(tokens_per_group * top_k * capacity_factor / num_experts) + 1
    # round up to a multiple of 4, as the reference does
    return max(min_capacity, (c + 3) & ~3)


def _route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: (T, D) → gates (T, k) f32, experts (T, k) int64, aux-loss scalar.

    A stable descending sort keeps ``jax.lax.top_k``'s order: the larger
    probability first, the lower expert index first among equals."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)   # (T, E)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :top_k], eidx[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    # Switch-style load-balance aux: E · Σ_e f_e · P_e
    E = router.shape[1]
    me = probs.mean(dim=0)
    # fraction of routed slots per expert: 1/n added per slot, as the
    # reference adds it (a count of fixed length E)
    flat = eidx.reshape(-1)
    ce = probs.new_zeros(E).scatter_add_(
        0, flat, probs.new_full(flat.shape, 1.0 / flat.numel()))
    return gates, eidx, E * torch.sum(me * ce)


def _route_grouped(router: torch.Tensor, bias: torch.Tensor,
                   x: torch.Tensor, mo: GroupRoutedMoE):
    """x: (T, D) → gates (T, k) f32, experts (T, k) int64, aux 0, as
    DeepSeek-V3's ``Gate`` routes: s = sigmoid(x W_r), c = s + b; a
    group's score is the sum of its two largest c; outside the best
    ``top_expert_groups`` groups c is −inf; the experts are the top k of
    c, their gates s renormalised to sum to one, times ``routed_scale``.
    The bias balances the load in place of an aux loss."""
    s = torch.sigmoid(x.float() @ router.float())               # (T, R)
    T, R = s.shape
    c = (s + bias.float()).view(T, mo.expert_groups, -1)
    best = c.topk(2, dim=-1).values.sum(-1).topk(
        mo.top_expert_groups, dim=-1).indices                  # (T, kg)
    out = torch.ones(T, mo.expert_groups, dtype=torch.bool,
                     device=x.device).scatter_(1, best, False)
    c = c.masked_fill(out[..., None], float("-inf")).view(T, R)
    eidx = c.topk(mo.top_k, dim=-1).indices
    gates = s.gather(1, eidx)
    gates = gates / gates.sum(-1, keepdim=True) * mo.routed_scale
    return gates, eidx, s.new_zeros(())


def _dispatch_compute(x: torch.Tensor, gates: torch.Tensor,
                      eidx: torch.Tensor, w_gate, w_up, w_down,
                      capacity: int, num_experts: int,
                      first: int = 0) -> torch.Tensor:
    """x: (T, D); gates/eidx: (T, k) → (T, D) f32 output of the experts
    ``[first, first + E_l)`` (``E_l = w_gate.shape[0]``) of the
    ``num_experts`` routed over (all of them unless expert-parallel or a
    held share).  A slot routed to another expert, or dropped, adds a
    zero row at row 0 and contributes 0: each kept destination gets one
    row plus zeros, so the sum is exact."""
    T, D = x.shape
    k = eidx.shape[1]
    E, El = num_experts, w_gate.shape[0]
    eflat = eidx.reshape(-1)                           # (T·k,)
    order = torch.argsort(eflat, stable=True)
    sorted_e = eflat[order]
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, eflat, torch.ones_like(eflat))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=x.device) - seg_start[sorted_e]
    local_e = sorted_e - first
    here = (local_e >= 0) & (local_e < El)
    mine = here & (pos_in_e < capacity)
    rec = trace_rec.ACTIVE
    if rec is not None:
        rec.moe_fill(T * k, mine, El * capacity, here)
    dest = torch.where(mine, local_e * capacity + pos_in_e, 0)
    token_of = order // k                              # source token per slot
    contrib = torch.where(mine[:, None], x[token_of], 0)
    buf = torch.zeros(El * capacity, D, device=x.device, dtype=x.dtype)
    buf = buf.index_add_(0, dest, contrib).reshape(El, capacity, D)
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out = torch.bmm(h, w_down).reshape(El * capacity, D)
    slot_out = torch.where(mine[:, None], out[dest], 0)   # (T·k, D)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    slot_out = slot_out[inv].reshape(T, k, D)
    return torch.einsum("tkd,tk->td", slot_out.float(), gates)


def moe_mix(params: dict, x: torch.Tensor, cfg, *, num_groups: int = 1,
            capacity_factor: float = 1.25, dp=None, ep=None):
    """MoE FFN body on pre-normed x: (B, S, D) → (out, aux_loss).

    The B·S tokens are split into ``num_groups`` routing groups (reduced
    until it divides B·S), each routed and dispatched on its own with the
    capacity of T / G tokens; the aux loss is the mean over groups.

    With ``dp`` (``distributed.parallel.DataParallel``) x is this rank's
    rows of the global batch, and the groups are the reference's: G
    groups of the *global* token stream (``dp.size`` ranks' rows in rank
    order).  Where G splits over the ranks a rank's rows are whole
    groups and it routes them; otherwise it gathers every rank's tokens,
    routes all G groups and keeps its rows.  ``aux`` is then this rank's
    share: the SUM over the ranks is the mean over all G groups.

    With ``ep`` (``distributed.parallel.TensorParallel`` over ``model``:
    ``size`` ranks, this one ``index``) the expert stacks in ``params``
    are this rank's ``E / size`` experts and the shared experts' gate and
    up columns and down rows its blocks.  Every rank routes every group
    (the router, ``keep`` and the aux loss are the same on each), runs
    its own experts' slots, and the partial outputs, shared ones
    included, are summed over ``model`` in f32 and rounded once.  Only
    the partial path's inputs (the tokens it dispatches, the gates it
    combines with) pass ``ep.copy_in``, so the router's and the aux
    loss's gradients are not summed over ``model``."""
    mo = cfg.moe
    B, S, D = x.shape
    n = dp.size if dp is not None else 1
    T = B * S * n
    xf = x.reshape(B * S, D)
    G = num_groups
    while T % G:
        G -= 1
    E, R = mo.num_experts, _routed(mo)
    cap = capacity_for(T // G, mo.top_k, R, capacity_factor)
    gathered = n > 1 and G % n != 0
    xs = dp.gather_rows(xf) if gathered else xf
    grouped = isinstance(mo, GroupRoutedMoE)
    first = mo.held_first if grouped else 0
    if ep is not None:
        if params["w_gate"].shape[0] * ep.size != E:
            raise ValueError(
                f"expert-parallel over {ep.size} ranks needs {E // ep.size} "
                f"experts a rank, got {params['w_gate'].shape[0]}")
        first += ep.index * params["w_gate"].shape[0]
    rec = trace_rec.ACTIVE
    if rec is not None:
        rec.open("model.moe.route")
    if grouped:
        routed = [_route_grouped(params["router"], params["router_bias"], xt,
                                 mo) for xt in xs.reshape(-1, T // G, D)]
    else:
        routed = [_route(params["router"], xt, mo.top_k)
                  for xt in xs.reshape(-1, T // G, D)]
    if rec is not None:
        rec.close()
    gates = torch.stack([g for g, _, _ in routed])
    xd = xs
    if ep is not None:                    # the partial path's inputs
        xd, gates = ep.copy_in(xs), ep.copy_in(gates)
    # rounded a group at a time, as the reference rounds; expert-parallel
    # partials stay f32 until their SUM
    dt = x.dtype if ep is None else torch.float32
    out = torch.cat([
        _dispatch_compute(xt, g, e, params["w_gate"], params["w_up"],
                          params["w_down"], cap, R, first).to(dt)
        for xt, g, (_, e, _) in zip(xd.reshape(-1, T // G, D), gates,
                                    routed)])
    rows = slice(dp.index * B * S, (dp.index + 1) * B * S) if gathered \
        else slice(None)
    out = out[rows]
    if mo.num_shared:
        xsh = xd[rows]
        sh = (F.silu(xsh @ params["s_gate"]) * (xsh @ params["s_up"])
              ) @ params["s_down"]
        out = out + sh.to(dt)
    if ep is not None:
        out = ep.reduce_out(out).to(x.dtype)
    auxs = torch.stack([a for _, _, a in routed])
    aux = (auxs.mean() if n == 1 else
           auxs.sum() / (G * (n if gathered else 1)))
    return out.reshape(B, S, D), aux * mo.router_aux_coef


def moe_ffn(params: dict, x: torch.Tensor, cfg, *, num_groups: int = 1,
            dp=None, ep=None):
    """Pre-norm residual MoE block: (B, S, D) → (x + out, aux).  A
    traced engine step times it as the ``model.moe`` span, its router's
    host time as the child ``model.moe.route`` (``core/recorder.py``)."""
    rec = trace_rec.ACTIVE
    if rec is not None:
        rec.model("model.moe")
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    out, aux = moe_mix(params, h, cfg, num_groups=num_groups, dp=dp, ep=ep)
    y = x + out
    if rec is not None:
        rec.model(None)
    return y, aux
