"""Which collectives gloo runs on CUDA tensors, and how fast.

Two ranks on one GPU can only meet over gloo (NCCL refuses two ranks on
one device), and gloo's support for CUDA tensors differs by collective
and by release.  :func:`probe` tries each collective the training slice
could build on, checks its answer, and times ``all_reduce`` (and every
collective that worked) at a few sizes; the design of
``distributed/collectives.py`` and ``distributed/pipeline.py`` follows
what it reports.

    PYTHONPATH=src python -m repro_torch.distributed.probe

starts two ranks on GPU 0 (rendezvous through a file under ``build/``),
prints each result as it comes and one JSON line per rank, and tries
``send``/``recv`` last (it aborts the process on torch 2.11+cu128).
``chip_smoke.py`` calls :func:`probe` inside its training ranks, without
the point-to-point check.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
import traceback

import torch
import torch.distributed as dist

#: message sizes of the timed collectives, in bytes of f32
SIZES = (64 << 20, 256 << 20, 1 << 30)


def _checks(rank: int, world: int, device) -> dict:
    """name → a function that runs one collective on this rank's CUDA
    tensors and returns True when every rank got the right answer."""
    n = 1024
    mine = torch.arange(n, dtype=torch.float32, device=device) + rank

    def full():
        return torch.cat([torch.arange(n, dtype=torch.float32,
                                       device=device) + r
                          for r in range(world)])

    def all_reduce_int32():
        x = torch.full((n,), rank + 1, dtype=torch.int32, device=device)
        dist.all_reduce(x)
        return bool((x == world * (world + 1) // 2).all())

    def all_reduce_max():
        x = mine.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return bool(torch.equal(x, mine - rank + world - 1))

    def broadcast():
        x = mine.clone()
        dist.broadcast(x, src=world - 1)
        return bool(torch.equal(x, mine - rank + world - 1))

    def all_gather_into_tensor():
        out = torch.empty(world * n, device=device)
        dist.all_gather_into_tensor(out, mine)
        return bool(torch.equal(out, full()))

    def all_gather():
        outs = [torch.empty(n, device=device) for _ in range(world)]
        dist.all_gather(outs, mine)
        return bool(torch.equal(torch.cat(outs), full()))

    def reduce_scatter_tensor():
        out = torch.empty(n, device=device)
        dist.reduce_scatter_tensor(out, full())
        want = full()[rank * n:(rank + 1) * n] * world
        return bool(torch.equal(out, want))

    def send_recv():
        """A ring: each rank sends to the next and receives from the
        previous (even ranks send first, so two ranks cannot deadlock)."""
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        got = torch.empty(n, device=device)
        if rank % 2 == 0:
            dist.send(mine, nxt)
            dist.recv(got, prv)
        else:
            dist.recv(got, prv)
            dist.send(mine, nxt)
        return bool(torch.equal(got, mine - rank + prv))

    return {"all_reduce_int32": all_reduce_int32,
            "all_reduce_max": all_reduce_max, "broadcast": broadcast,
            "all_gather_into_tensor": all_gather_into_tensor,
            "all_gather": all_gather,
            "reduce_scatter_tensor": reduce_scatter_tensor,
            "send_recv": send_recv}


def _timed(fn, device, reps: int = 3) -> float:
    """Median wall seconds of ``fn`` (gloo returns once the host copies
    are back; synchronise around it all the same)."""
    secs = []
    fn()
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def probe(device=None, report=None, *, point_to_point: bool = False) -> dict:
    """Run on every rank of the default (gloo) group, CUDA tensors on
    ``device``: ``{"seconds": {name: {bytes: s}}, "works": {name: true |
    false | error}}``.  ``all_reduce`` is timed first; then each
    collective is checked (point-to-point last: gloo may take a CUDA
    pointer for a host one there and abort the process), and timed if
    it worked.  ``report(line)``, if given, sees each result as it
    comes.  ``point_to_point`` adds ``send``/``recv`` last: on torch
    2.11+cu128 gloo hands the CUDA pointer to ``writev`` ("Bad
    address") and the process aborts, so only :func:`main` tries it."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    report = report or (lambda line: None)
    rank, world = dist.get_rank(), dist.get_world_size()
    seconds: dict = {}

    def timed(name, make):
        for nbytes in SIZES:
            x = torch.ones(nbytes // 4, device=device)
            seconds.setdefault(name, {})[nbytes] = _timed(make(x), device)
            report(f"{name} {nbytes >> 20} MB: "
                   f"{seconds[name][nbytes] * 1e3:.1f} ms")
            del x
            torch.cuda.empty_cache()

    timed("all_reduce", lambda x: lambda: dist.all_reduce(x))
    works = {}

    def check(name, fn):
        try:
            works[name] = fn()
        except Exception:                   # report, and probe the rest
            works[name] = traceback.format_exc().strip().splitlines()[-1]
        report(f"{name}: {works[name]}")

    checks = _checks(rank, world, device)
    p2p = checks.pop("send_recv")
    for name, fn in checks.items():
        check(name, fn)
    if works["all_gather_into_tensor"] is True:
        timed("all_gather_into_tensor", lambda x: lambda: (
            dist.all_gather_into_tensor(x, x[:x.numel() // world])))
    if works["broadcast"] is True:
        timed("broadcast", lambda x: lambda: dist.broadcast(x, src=0))
    if point_to_point:
        check("send_recv", p2p)
    return {"works": works, "seconds": seconds}


def describe(result: dict) -> list[str]:
    """Printable lines of one rank's :func:`probe` result."""
    def verdict(v):
        return ("works" if v is True else
                "wrong answer" if v is False else f"refused: {v}")
    lines = ["gloo on CUDA tensors: " + ", ".join(
        f"{k} {verdict(v)}" for k, v in result["works"].items())]
    for name, by_size in result["seconds"].items():
        lines.append(f"{name}: " + ", ".join(
            f"{int(b) >> 20} MB {s * 1e3:.1f} ms ({int(b) / s / 1e9:.2f} GB/s)"
            for b, s in by_size.items()))
    return lines


def _rank(rank: int, world: int, store: str) -> None:
    from datetime import timedelta
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        res = probe(report=lambda line: print(f"rank {rank}: {line}",
                                              flush=True),
                    point_to_point=True)
        print(json.dumps({"rank": rank, **res}))
        for line in describe(res):
            print(f"rank {rank}: {line}")
    finally:
        dist.destroy_process_group()


def main() -> int:
    import os
    import subprocess
    if len(sys.argv) == 4:
        _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs("build", exist_ok=True)
    store = os.path.abspath("build/probe_store")
    if os.path.exists(store):
        os.remove(store)
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, str(r),
                               "2", store]) for r in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return 0 if codes == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
