"""The closed loop that drives ``Engine.step``, and the window's record.

Each client is one session and one FPR recycling context
(``group_id`` = client + 1) and sends its next request as soon as the
previous one completes.  After every step the loop reads, from the
engine's requests, the prompt tokens each request has prefilled and the
tokens it has generated, and stamps them with the host clock at the
step's end (each step ends in the logits' copy to the host, so that is
when its tokens exist).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Req:
    req: object               # the engine's Request
    submit_t: float
    prompt_len: int
    prefilled: int = 0
    prefills: list = field(default_factory=list)   # (t, first, end)
    times: list = field(default_factory=list)      # each token's time
    done_t: float | None = None

    @property
    def tokens(self) -> list:
        return [int(t) for t in self.req.generated]


class Loop:
    def __init__(self, eng, traffic, clients: int):
        self.eng = eng
        self.traffic = traffic
        self.clients = clients
        self.live: dict[int, Req] = {}
        self.reqs: list[Req] = []
        self.step_ends: list[float] = []
        self._next = 0
        self.closed_loop = True

    def submit(self, client: int, prompt=None, max_new: int | None = None):
        if prompt is None:
            prompt, max_new = self.traffic.request(self._next)
            self._next += 1
        t = time.perf_counter()
        rid = self.eng.submit(prompt, max_new, stream=f"client{client}",
                              group_id=client + 1)
        q = self.eng.sched.queue[-1]
        assert q.rid == rid
        r = Req(q, t, len(prompt))
        self.live[client] = r
        self.reqs.append(r)
        return r

    def step(self) -> float:
        self.eng.step()
        t = time.perf_counter()
        self.step_ends.append(t)
        for client in sorted(self.live):
            r = self.live[client]
            q = r.req
            n = len(q.generated)
            if n < len(r.times):
                raise RuntimeError(f"request {q.rid} lost tokens (preempted)")
            pre = r.prompt_len if q.state in ("running", "done") \
                else q.prefill_pos
            if pre > r.prefilled:
                r.prefills.append((t, r.prefilled, pre))
                r.prefilled = pre
            r.times.extend([t] * (n - len(r.times)))
            if q.state == "done":
                r.done_t = t
                del self.live[client]
                if self.closed_loop:
                    self.submit(client)
        return t

    def start(self) -> None:
        for c in range(self.clients):
            self.submit(c)

    def run_until(self, stop) -> float:
        while True:
            t = self.step()
            if stop(t):
                return t


def warm_up(loop: Loop, chunked: bool, block: int) -> None:
    """Every shape the cell's traffic uses, then the traffic itself until
    every client has completed a request, so that the window starts in
    the steady state (the slots no longer start together).  A monolithic
    prefill sees one shape per padded prompt length: one short request of
    each goes first."""
    if not chunked:
        loop.closed_loop = False
        for i, n in enumerate(loop.traffic.prompt_blocks(block)):
            loop.submit(i % loop.clients, loop.traffic.ids(i, n, stream=2), 2)
            if len(loop.live) == loop.clients:
                loop.run_until(lambda t: not loop.live)
        loop.run_until(lambda t: not loop.live)
        loop.closed_loop = True
    loop.start()
    first = loop.reqs[-loop.clients:]
    loop.run_until(lambda t: all(r.done_t is not None for r in first))
