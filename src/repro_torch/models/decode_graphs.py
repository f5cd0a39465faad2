"""Piecewise CUDA graphs of the single-device decode step.

At a serving batch a decode layer is some 75 small eager ops (norm,
projections, rope, the cache write, the output projection, the FFN; an
MoE FFN's router and dispatch some 40 more), and the host's enqueue of
them, not the device, paces the step.  :class:`DecodeGraphs` splits the
step at each layer's attention kernel call (the paged-decode kernel of
a GQA layer, the latent-context kernel of an MLA layer) into
``n_layers + 1`` pieces:

  piece 0      the embedding, the cache targets (``_token_targets``), and
               layer 0's norm and query with its token's cache write
               (GQA: QKV with rope, fused K/V; MLA: the latent and rope
               key, then the absorbed query), then ``lengths + 1`` (the
               kernel's lengths, once a step);
  piece i      layer i-1's output (GQA: projection and residual; MLA:
               ``mla_out``) and its FFN, dense or MoE, then layer i's
               norm, query and cache write;
  piece L      layer L-1's output and FFN, the final norm and the f32
               logits.

The ops of the pieces are those of ``transformer._decode_step``, in its
order and dtypes.  Between pieces the kernel runs eagerly (through
``transformer._paged_attn``, or ``mla_attention.ops.mla_paged_ctx_fwd``,
so that the wrapper sees each launch), and its output is copied into
the static buffer the next piece reads.  On a CUDA device each piece is
captured once into a CUDA graph, all of them into one memory pool, and
replayed each step; elsewhere (the CPU tests) the pieces run eagerly
over the same buffers.

Before each step the tokens, ``lengths`` and the ``(W, Bs, M)`` table
stack are copied into static int32 buffers, so a table the engine
replaced or rewrote in place (a recycled block remapped, a row at -1
for a slot mid-prefill) is read as it stands.  The pieces write the
pools in place and read the weights where ``params`` holds them, so the
capture is keyed on ``params`` (the object), the config, the MoE
routing groups, the shapes of the inputs and the pools, the pools'
dtype and their addresses; a step whose key differs from the captured
one captures again.  The step that captures computes its result
eagerly (on the capture stream, which also sets up that stream's cuBLAS
workspace before the capture).

A replay runs no Python, so the span recorder (``core/recorder.py``)
sees no ``model.moe`` span inside it.  The MoE dispatches' slot counts
are captured instead: while the pieces are captured, :class:`_Counts`
stands in for the recorder, and the graphs write each step's counts
into static device tensors, which a replay hands to the recorder when
one is on.
"""

from __future__ import annotations

import torch

from repro_torch.core import recorder as trace_rec
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import drop_write, rms_norm

#: the pools a decode state may hold (those of the mixers taken)
POOLS = ("kv", "mla_c", "mla_rope")


def _layer_in(lp, cfg, i, x, positions, targets, st):
    """Layer ``i``'s norm and query, and its token's cache write: x (B,
    D) → the kernel's query, q (B, H, hd) (GQA) or (q_lat, q_rope) f32
    (MLA)."""
    h = rms_norm(x[:, None], lp["mix"]["norm"], cfg.norm_eps)
    if cfg.mixers[i] == "mla":
        c_kv, k_rope = mla_mod.latent_kv(lp["mix"], h, cfg, positions)
        drop_write(st["mla_c"][i], targets, c_kv[:, 0])
        drop_write(st["mla_rope"][i], targets, k_rope[:, 0, 0])
        q_lat, q_rope, _ = mla_mod.absorbed_query(lp["mix"], x,
                                                  positions[:, 0], cfg)
        return q_lat.contiguous(), q_rope.contiguous()
    q, _, _, kv = tfm._attn_qkv(lp["mix"], h, cfg, positions, None)
    drop_write(st["kv"][i], targets, kv[:, 0])   # every layer attends
    return q[:, 0]


def _layer_out(lp, cfg, i, x, o, moe_groups):
    """Layer ``i``'s output (GQA: projection and residual; MLA:
    ``mla_out``) and its FFN: x (B, D), o the kernel's output → x."""
    if cfg.mixers[i] == "mla":
        x = mla_mod.mla_out(lp["mix"], x, o,
                            mla_mod.absorbed_weights(lp["mix"], cfg)[1])
    else:
        x = x + attn_mod.out_proj(o, lp["mix"]["wo"], cfg, None)
    return tfm._ffn(lp, x[:, None], cfg, i, moe_groups)[:, 0]


def plain_decoder(cfg) -> bool:
    """A decoder whose layers are all attention or all MLA, with dense or
    MoE FFNs: no per-slot recurrent state, no encoder."""
    return (not cfg.enc_dec and set(cfg.mixers) in ({"attn"}, {"mla"})
            and set(cfg.ffns) <= {"dense", "moe"})


class _Counts:
    """Stands in for the span recorder while the pieces are captured:
    each MoE dispatch's slot counts go into static device tensors (the
    first dispatch of the step writes them, the others add), and its
    spans are not opened.  ``slots`` and ``rows`` are the step's, fixed
    by its shapes."""

    def __init__(self, device):
        self.kept = torch.zeros((), dtype=torch.long, device=device)
        self.here = torch.zeros((), dtype=torch.long, device=device)
        self.slots = self.rows = 0

    def model(self, name):
        pass

    def open(self, name, *a, **k):
        pass

    def close(self):
        pass

    def moe_fill(self, slots, kept, rows, here):
        if self.slots:
            self.kept.add_(kept.sum())
            self.here.add_(here.sum())
        else:
            self.kept.copy_(kept.sum())
            self.here.copy_(here.sum())
        self.slots += slots
        self.rows += rows

    def hand_to(self, rec) -> None:
        """Add the last replayed step's counts to ``rec``."""
        if self.slots:
            rec.moe_fill(self.slots, self.kept, self.rows, self.here)


class DecodeGraphs:
    """The pieces of one engine's decode step and their graphs (module
    doc).  ``steps`` counts the steps served, ``captures`` the captures
    (recaptures included)."""

    def __init__(self):
        self._key = None
        self._params = None
        self._io: dict = {}        # the static tensors of the pieces
        self._pieces: list = []    # the pieces, or their graphs' replays
        self._counts = None        # the captured MoE counts (_Counts)
        self.steps = 0
        self.captures = 0

    @staticmethod
    def takes(cfg, page_impl: str) -> bool:
        """Whether the pieces serve ``cfg``'s decode step: the CUDA
        kernels over a :func:`plain_decoder` (a mesh or a layout is for
        ``transformer.decode_step`` to rule out)."""
        return page_impl == "kernel" and plain_decoder(cfg)

    def _make_pieces(self, params, cfg, st, moe_groups) -> list:
        """The L + 1 pieces over ``self._io``: each reads what the static
        inputs and earlier pieces left there and adds its outputs under
        keys of its own, so that every static tensor stays alive."""
        io = self._io
        lps = [tfm.layer_params(params, cfg, i) for i in range(cfg.n_layers)]
        L = cfg.n_layers

        def first():
            pos = io["lengths"]
            io["x", 0] = tfm._embed_tokens(params, io["tokens"], None)
            io["positions"] = pos[:, None]
            B = io["tokens"].shape[0]
            io["targets"] = tfm._token_targets(
                io["tables"], torch.arange(B, device=pos.device), pos,
                tfm.BLOCK_SIZE)
            io["q", 0] = _layer_in(lps[0], cfg, 0, io["x", 0],
                                   io["positions"], io["targets"], st)
            io["kv_lengths"] = pos + 1

        def middle(i):
            def piece():
                io["x", i] = _layer_out(lps[i - 1], cfg, i - 1,
                                        io["x", i - 1], io["o"], moe_groups)
                io["q", i] = _layer_in(lps[i], cfg, i, io["x", i],
                                       io["positions"], io["targets"], st)
            return piece

        def last():
            x = _layer_out(lps[L - 1], cfg, L - 1, io["x", L - 1], io["o"],
                           moe_groups)
            h = rms_norm(x, params["final_norm"], cfg.norm_eps)
            io["logits"] = tfm._logits(params, cfg, h, None)

        return [first] + [middle(i) for i in range(1, L)] + [last]

    def _inputs(self, state: dict, tokens: torch.Tensor) -> None:
        """Copy the step's inputs into the static buffers (made at the
        first step of a key)."""
        io = self._io
        if "tokens" not in io:
            dev = tokens.device
            io["tokens"] = torch.empty(tokens.shape, dtype=torch.int32,
                                       device=dev)
            io["lengths"] = torch.empty(state["lengths"].shape,
                                        dtype=torch.int32, device=dev)
            io["tables"] = torch.empty(state["tables"].shape,
                                       dtype=torch.int32, device=dev)
        io["tokens"].copy_(tokens)
        io["lengths"].copy_(state["lengths"])
        io["tables"].copy_(state["tables"])

    def _kernel(self, cfg, st, i):
        """Layer ``i``'s attention kernel over the static inputs, eagerly:
        the kernel's output (B, H, hd), or the MLA latent context."""
        io = self._io
        if cfg.mixers[i] == "mla":
            from repro_torch.kernels.mla_attention import ops as mla_ops
            from repro_torch.kernels.paged_attention.ops import \
                shard_descriptor
            m = cfg.mla
            q_lat, q_rope = io["q", i]
            return mla_ops.mla_paged_ctx_fwd(
                q_lat, q_rope, st["mla_c"][i], st["mla_rope"][i],
                shard_descriptor(io["tables"])[0], io["kv_lengths"],
                scale=float((m.nope_head_dim + m.rope_head_dim) ** -0.5))
        return tfm._paged_attn(io["q", i], st["kv"][i], io["tables"],
                               io["kv_lengths"], page_impl="kernel",
                               window=cfg.attn.window)

    def _chain(self, cfg, st, rec) -> torch.Tensor:
        """Each piece, then layer i's attention kernel, eagerly, into the
        static buffer the next piece reads; returns the logits."""
        io = self._io
        for i, piece in enumerate(self._pieces):
            if rec is not None:
                rec.model("model.graph")
            piece()
            if i == cfg.n_layers:
                break
            if rec is not None:
                rec.model("model.attn")
            o = self._kernel(cfg, st, i)
            if "o" not in io:
                io["o"] = torch.empty_like(o)
            io["o"].copy_(o)
        if rec is not None:
            rec.model(None)
        return io["logits"]

    def _capture(self, cfg, st, rec) -> torch.Tensor:
        """Run the step eagerly on a side stream, then capture each piece
        there into one memory pool, with :class:`_Counts` in the
        recorder's place; returns the eager logits."""
        dev = st["lengths"].device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        counts = _Counts(dev)
        with torch.cuda.stream(side):
            logits = self._chain(cfg, st, rec)
            trace_rec.ACTIVE = counts
            try:
                for piece in self._pieces:
                    g = torch.cuda.CUDAGraph()
                    g.capture_begin(pool=pool)
                    try:
                        piece()
                    finally:
                        g.capture_end()
                    graphs.append(g)
            finally:
                trace_rec.ACTIVE = rec
        cur.wait_stream(side)
        logits.record_stream(cur)
        self._pieces = [g.replay for g in graphs]
        self._counts = counts
        self.captures += 1
        if rec is not None:
            rec.decode_graph(captured=True)
        return logits

    def step(self, params, cfg, state: dict, tokens: torch.Tensor,
             moe_groups: int = 1):
        """One decode step: tokens (B,) → (logits (B, V) f32, state), as
        ``transformer.decode_step`` returns them."""
        rec = trace_rec.ACTIVE
        pools = [state[k] for k in POOLS if k in state]
        key = (cfg, moe_groups, tuple(tokens.shape), tokens.device,
               tuple(state["lengths"].shape), tuple(state["tables"].shape),
               *((tuple(p.shape), p.dtype, p.data_ptr()) for p in pools))
        fresh = key != self._key or params is not self._params
        if fresh:
            self._key, self._params, self._io = key, params, {}
            self._pieces = self._make_pieces(params, cfg, state, moe_groups)
        self._inputs(state, tokens)
        if tokens.device.type != "cuda":        # no graphs: run the pieces
            logits = self._chain(cfg, state, rec)
        elif fresh:
            logits = self._capture(cfg, state, rec)
        else:
            # the replayed logits are overwritten by the next replay
            logits = self._chain(cfg, state, rec).clone()
            if rec is not None:
                rec.decode_graph(captured=False)
                self._counts.hand_to(rec)
        self.steps += 1
        st = dict(state)
        st["lengths"] = state["lengths"] + 1
        return logits, st
