"""CUDA graphs of the monolithic prefill, one per padded prompt length.

``Engine._prefill_request`` prefills one request a call, its prompt
padded to a multiple of the block size, so a call's shapes are those of
its padded length ``Sp``: tokens (1, Sp), the request's table row and
its lengths.  Eagerly a layer of it is a few hundred small ops
(``chunked_attention`` alone runs some 25 a 256-key chunk), and the
host's enqueue of them, not the device, paces the call.
:class:`PrefillGraphs` holds one CUDA graph of the whole
``transformer._prefill`` body for each padded length and replays it.

The body is ``transformer._prefill`` itself, called over static int32
buffers that hold the tokens, the table row and ``lengths``: its ops,
their order and dtypes, the f32 chunked attention, the MoE capacity
drops and the logits head.  Each call copies its values into those
buffers before the replay, so a recycled block remapped in place is read
as it stands.  The body writes the pools in place and reads the weights
where ``params`` holds them, so the graphs are keyed on ``params`` (the
object), the config, ``impl``, the MoE routing groups, the table's and
lengths' shapes, and the pools' shapes, dtype and addresses; a call whose
key differs drops every graph and captures again.  A call of a padded
length not seen under the key runs the body eagerly on the capture
stream (which also sets up that stream's cuBLAS workspace), then
captures it.

All the graphs of a key capture into one memory pool (a new key's
graphs into a new one: dropping the last graph of a pool frees it).
Replays run on one stream, never two at once, and each replay's outputs
(the logits and lengths) are copied out at once, before another graph's
replay can reuse their memory; the static inputs and the MoE counts
live outside the pool.  Off the card the body runs eagerly over the same
buffers (the CPU tests).

A replay runs no Python, so the span recorder (``core/recorder.py``)
sees none of the body's ranges or spans.  As in ``decode_graphs``, a
``_Counts`` stands in for the recorder while a body is captured, each
replay hands the recorder the MoE dispatches' slot counts, the replay
runs inside the profiler range ``model.prefill.graph``, and the
recorder counts the replays and the captures (``trace.prefill.*``).
"""

from __future__ import annotations

import torch

from repro_torch.core import recorder as trace_rec
from repro_torch.models import transformer as tfm
from repro_torch.models.decode_graphs import POOLS, _Counts, plain_decoder


class _Graph:
    """One padded length's static buffers, its body over them and, once
    captured, its graph and MoE counts."""

    def __init__(self, params, cfg, state: dict, tokens: torch.Tensor, *,
                 impl: str, moe_groups: int):
        dev = tokens.device
        io = self.io = {k: torch.empty(t.shape, dtype=torch.int32,
                                       device=dev)
                        for k, t in (("tokens", tokens),
                                     ("tables", state["tables"]),
                                     ("lengths", state["lengths"]))}
        pools = {k: state[k] for k in POOLS if k in state}

        def body():
            view = dict(pools, tables=io["tables"], lengths=io["lengths"])
            io["logits"], st = tfm._prefill(
                params, cfg, io["tokens"], view, impl=impl, enc_frames=None,
                patches=None, moe_groups=moe_groups, mesh=None,
                batch_axes=(), seq_axes=("model",))
            io["lengths_out"] = st["lengths"]
            return io["logits"], io["lengths_out"]
        self.body = body
        self.graph = None
        self.counts = None

    def inputs(self, tokens: torch.Tensor, state: dict) -> None:
        io = self.io
        io["tokens"].copy_(tokens)
        io["tables"].copy_(state["tables"])
        io["lengths"].copy_(state["lengths"])


class PrefillGraphs:
    """The graphs of one engine's monolithic prefills, one per padded
    length (module doc).  ``calls`` counts the prefills served,
    ``captures`` the captures (recaptures included)."""

    def __init__(self):
        self._key = None
        self._params = None
        self._graphs: dict = {}    # tokens' shape -> _Graph
        self._stream = None        # the capture stream
        self._pool = None          # the graphs' one memory pool
        self.calls = 0
        self.captures = 0

    @staticmethod
    def takes(cfg) -> bool:
        """Whether the graphs serve ``cfg``'s prefill: a decoder whose
        layers are all attention or all MLA, with dense or MoE FFNs (the
        inputs, a mesh or a layout are for ``transformer.prefill`` to rule
        out)."""
        return plain_decoder(cfg)

    def _capture(self, g: _Graph, rec):
        """Run ``g``'s body eagerly on the capture stream, then capture
        it there into the pool, with :class:`_Counts` in the recorder's
        place; returns the eager outputs."""
        dev = g.io["tokens"].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(dev)
        side = self._stream
        side.wait_stream(cur)
        counts = _Counts(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            out = g.body()
            # the eager pass's intermediates stay cached for the capture
            # stream, which runs nothing else: free them before the graph
            # takes its own from the pool
            torch.cuda.empty_cache()
            trace_rec.ACTIVE = counts
            try:
                graph.capture_begin(pool=self._pool)
                try:
                    g.body()
                finally:
                    graph.capture_end()
            finally:
                trace_rec.ACTIVE = rec
        cur.wait_stream(side)
        for t in out:
            t.record_stream(cur)
        g.graph, g.counts = graph, counts
        self.captures += 1
        if rec is not None:
            rec.prefill_graph(captured=True)
        return out

    def prefill(self, params, cfg, tokens: torch.Tensor, state: dict, *,
                impl: str, moe_groups: int):
        """One prefill: tokens (B, Sp) → (last logits (B, V) f32, state),
        as ``transformer.prefill`` returns them."""
        rec = trace_rec.ACTIVE
        pools = [state[k] for k in POOLS if k in state]
        key = (cfg, impl, moe_groups, tokens.device,
               tuple(state["tables"].shape), tuple(state["lengths"].shape),
               *((tuple(p.shape), p.dtype, p.data_ptr()) for p in pools))
        if key != self._key or params is not self._params:
            # the dropped graphs free the pool: the next capture opens one
            self._key, self._params, self._graphs = key, params, {}
            self._pool = None
        g = self._graphs.get(tuple(tokens.shape))
        if g is None:
            g = self._graphs[tuple(tokens.shape)] = _Graph(
                params, cfg, state, tokens, impl=impl, moe_groups=moe_groups)
        g.inputs(tokens, state)
        if tokens.device.type != "cuda":        # no graphs: run the body
            logits, lengths = g.body()
        elif g.graph is None:
            logits, lengths = self._capture(g, rec)
        else:
            if rec is not None:
                rec.model("model.prefill.graph")
            g.graph.replay()
            # another graph's replay may reuse the outputs' memory
            logits = g.io["logits"].clone()
            lengths = g.io["lengths_out"].clone()
            if rec is not None:
                rec.model(None)
                rec.prefill_graph(captured=False)
                g.counts.hand_to(rec)
        self.calls += 1
        st = dict(state)
        st["lengths"] = lengths
        return logits, st
