"""Piecewise CUDA graphs of the single-device GQA decode step.

At a serving batch a decode layer of a dense attention model is some 75
small eager ops (norm, projections, rope, the cache write, the output
projection, the FFN), and the host's enqueue of them, not the device,
paces the step.  :class:`DecodeGraphs` splits the step at each
attention layer's paged-decode kernel call into ``n_layers + 1``
pieces:

  piece 0      the embedding, the cache targets (``_token_targets``), and
               layer 0's norm, QKV with rope, fused K/V and cache write,
               then ``lengths + 1`` (the kernel's lengths, once a step);
  piece i      layer i-1's output projection and residual and its dense
               FFN, then layer i's norm, QKV, rope and cache write;
  piece L      layer L-1's output projection and FFN, the final norm and
               the f32 logits.

The ops of the pieces are those of ``transformer._decode_step``, in its
order and dtypes.  Between pieces the paged-decode kernel runs eagerly
through ``transformer._paged_attn`` (so ``ops.paged_attention_fused_fwd``
sees each launch), and its output is copied into the static buffer the
next piece reads.  On a CUDA device each piece is captured once into a
CUDA graph, all of them into one memory pool, and replayed each step;
elsewhere (the CPU tests) the pieces run eagerly over the same buffers.

Before each step the tokens, ``lengths`` and the ``(W, Bs, M)`` table
stack are copied into static int32 buffers, so a table the engine
replaced or rewrote in place (a recycled block remapped, a row at -1
for a slot mid-prefill) is read as it stands.  The pieces write the KV
pool in place and read the weights where ``params`` holds them, so the
capture is keyed on ``params`` (the object), the config, the shapes of
the inputs and the pool, the pool's dtype and its address; a step whose
key differs from the captured one captures again.  The step that
captures computes its result eagerly (on the capture stream, which also
sets up that stream's cuBLAS workspace before the capture).
"""

from __future__ import annotations

import torch

from repro_torch.core import recorder as trace_rec
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_ffn, drop_write, rms_norm


def _layer_in(lp, cfg, x, positions, targets, pool):
    """A layer's norm, QKV with rope, and its token's cache write: x (B,
    D) → q (B, H, hd)."""
    h = rms_norm(x[:, None], lp["mix"]["norm"], cfg.norm_eps)
    q, _, _, kv = tfm._attn_qkv(lp["mix"], h, cfg, positions, None)
    drop_write(pool, targets, kv[:, 0])
    return q[:, 0]


def _layer_out(lp, cfg, x, o):
    """A layer's output projection, residual and dense FFN: x (B, D), o
    (B, H, hd) → x."""
    x = x + attn_mod.out_proj(o, lp["mix"]["wo"], cfg, None)
    return dense_ffn(lp["ffn"], x[:, None], cfg.norm_eps)[:, 0]


class DecodeGraphs:
    """The pieces of one engine's decode step and their graphs (module
    doc).  ``steps`` counts the steps served, ``captures`` the captures
    (recaptures included)."""

    def __init__(self):
        self._key = None
        self._params = None
        self._io: dict = {}        # the static tensors of the pieces
        self._pieces: list = []    # the pieces, or their graphs' replays
        self.steps = 0
        self.captures = 0

    @staticmethod
    def takes(cfg, page_impl: str) -> bool:
        """Whether the pieces serve ``cfg``'s decode step: the CUDA paged
        kernel over an attention-only, dense-FFN decoder (a mesh or a
        layout is for ``transformer.decode_step`` to rule out)."""
        return (page_impl == "kernel" and not cfg.enc_dec
                and all(m == "attn" for m in cfg.mixers)
                and all(f == "dense" for f in cfg.ffns))

    def _make_pieces(self, params, cfg, kv) -> list:
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
            io["q", 0] = _layer_in(lps[0], cfg, io["x", 0], io["positions"],
                                   io["targets"], kv[0])
            io["kv_lengths"] = pos + 1

        def middle(i):
            def piece():
                io["x", i] = _layer_out(lps[i - 1], cfg, io["x", i - 1],
                                        io["o"])
                io["q", i] = _layer_in(lps[i], cfg, io["x", i],
                                       io["positions"], io["targets"], kv[i])
            return piece

        def last():
            x = _layer_out(lps[L - 1], cfg, io["x", L - 1], io["o"])
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

    def _chain(self, cfg, kv, rec) -> torch.Tensor:
        """Each piece, then layer i's paged-decode kernel, eagerly, into
        the static buffer the next piece reads; returns the logits."""
        io = self._io
        for i, piece in enumerate(self._pieces):
            if rec is not None:
                rec.model("model.graph")
            piece()
            if i == cfg.n_layers:
                break
            if rec is not None:
                rec.model("model.attn")
            o = tfm._paged_attn(io["q", i], kv[i], io["tables"],
                                io["kv_lengths"], page_impl="kernel",
                                window=cfg.attn.window)
            if "o" not in io:
                io["o"] = torch.empty_like(o)
            io["o"].copy_(o)
        if rec is not None:
            rec.model(None)
        return io["logits"]

    def _capture(self, cfg, kv, rec) -> torch.Tensor:
        """Run the step eagerly on a side stream, then capture each piece
        there into one memory pool; returns the eager logits."""
        cur = torch.cuda.current_stream(kv.device)
        side = torch.cuda.Stream(kv.device)
        side.wait_stream(cur)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        with torch.cuda.stream(side):
            logits = self._chain(cfg, kv, rec)
            for piece in self._pieces:
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool)
                try:
                    piece()
                finally:
                    g.capture_end()
                graphs.append(g)
        cur.wait_stream(side)
        logits.record_stream(cur)
        self._pieces = [g.replay for g in graphs]
        self.captures += 1
        if rec is not None:
            rec.decode_graph(captured=True)
        return logits

    def step(self, params, cfg, state: dict, tokens: torch.Tensor):
        """One decode step: tokens (B,) → (logits (B, V) f32, state), as
        ``transformer.decode_step`` returns them."""
        rec = trace_rec.ACTIVE
        kv = state["kv"]
        key = (cfg, tuple(tokens.shape), tokens.device,
               tuple(state["lengths"].shape), tuple(state["tables"].shape),
               tuple(kv.shape), kv.dtype, kv.data_ptr())
        fresh = key != self._key or params is not self._params
        if fresh:
            self._key, self._params, self._io = key, params, {}
            self._pieces = self._make_pieces(params, cfg, kv)
        self._inputs(state, tokens)
        if tokens.device.type != "cuda":        # no graphs: run the pieces
            logits = self._chain(cfg, kv, rec)
        elif fresh:
            logits = self._capture(cfg, kv, rec)
        else:
            # the replayed logits are overwritten by the next replay
            logits = self._chain(cfg, kv, rec).clone()
            if rec is not None:
                rec.decode_graph(captured=False)
        self.steps += 1
        st = dict(state)
        st["lengths"] = state["lengths"] + 1
        return logits, st
