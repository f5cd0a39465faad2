"""One run of one cell: set-up, warm-up, the measured window, the
metrics, and the output check.

:func:`run_cell` takes the device as an argument, so the CPU tests can
drive a whole run at a smoke size; ``run.py`` refuses to run without
the chips a cell asks for.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import time
from pathlib import Path

import torch

from perfbench import check, model
from perfbench.serve import Loop, warm_up
from perfbench.traffic import Traffic
from perfbench.window import Record

#: seconds of the window the profiler traces (from its start)
TRACE_SECONDS = 5.0
#: where the profiler's trace is written and read back (then deleted):
#: inside the checkout, ignored by git
TRACE_FILE = Path(__file__).resolve().parents[1] / "build" / "perfbench" \
    / "trace.json"


def dims(cfg, workload: dict, dtype, pool_dtype) -> dict:
    """The kernels' shapes, as ``perfbench/work`` reads them."""
    m = cfg.mla
    return {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim,
            "attn_layers": sum(x == "attn" for x in cfg.mixers),
            "mla_layers": sum(x == "mla" for x in cfg.mixers),
            "rank": m.kv_lora_rank if m else 0,
            "rope": m.rope_head_dim if m else 0,
            "pool_bytes": torch.empty(0, dtype=pool_dtype).element_size(),
            "act_bytes": torch.empty(0, dtype=dtype).element_size(),
            "block": model.BLOCK,
            "table_cols": -(-workload["engine"]["max_seq_len"] // model.BLOCK)}


def reader(name: str):
    """``perfbench/metrics/<name>.py`` (a name may hold dots)."""
    path = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
    mod_name = "perfbench.metrics." + name.replace(".", "__")
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def read_metrics(entries: list, rec: Record) -> dict:
    out = {}
    for m in entries:
        v = reader(m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             age=lambda: None, cfg=None, control: bool = False) -> dict:
    """The result of one run (the last line's keys, before ``device``'s
    card fields).  ``age`` gives the seconds since the process started;
    ``cfg`` overrides the port config (tests); ``control`` also reads
    the fp8 control's numbers on the checked requests.  In a traced run
    the profiler's stop (a few seconds, once) is left out of the
    window."""
    t_begin = time.perf_counter()
    phases = {"before_harness": age()}

    def mark(name):
        _sync(device)
        phases[name] = time.perf_counter() - t_begin
    conf = cell.config
    cfg = cfg or model.port_config(conf)
    dtype = model.DTYPES[conf["port"]["dtype"]]
    pool_dtype = model.DTYPES[conf["port"]["pool_dtype"]]
    if torch.device(device).type == "cuda":
        # every kernel built (the first run of a checkout) or loaded before
        # any request is timed
        from repro_torch.kernels import _build
        _build.build_all()
        mark("kernels")
    params = model.make_params(cfg, seed, dtype, device)
    mark("weights")
    eng = model.build_engine(cfg, params, cell.workload, pool_dtype, device)
    mark("engine")
    traffic = Traffic(cell.traffic, seed, conf["vocab_size"])
    loop = Loop(eng, traffic, traffic.clients)
    tracer = None
    if trace:
        from perfbench.trace import Tracer
        tracer = Tracer(torch)
        tracer.install()
    try:
        warm_up(loop, chunked=eng._chunked, block=model.BLOCK)
        mark("warm_up")
        counters0 = eng.metrics.snapshot()
        if tracer:              # the profiler starts before the window
            tracer.start_profile()
            tracer.on = True
        t0 = time.perf_counter()
        setup_s = age()
        if setup_s is None:
            setup_s = t0 - t_begin
        n0 = len(loop.step_ends)
        paused = 0.0

        def stop(t):
            nonlocal paused
            if tracer and tracer.profiling and t - t0 >= min(
                    TRACE_SECONDS, seconds):
                tracer.stop_profile()
                paused = time.perf_counter() - t
            return t - t0 - paused >= seconds
        t1 = loop.run_until(stop)
        if tracer:
            tracer.on = False
            if tracer.profiling:
                tracer.stop_profile()
        counters1 = eng.metrics.snapshot()
    finally:
        if tracer:
            tracer.uninstall()
    mark("window_end")
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    reduced = None
    if tracer:
        from perfbench import trace as tr
        reduced = tr.reduce(tracer.profile_events(TRACE_FILE))
    rec = Record(cell=cell, dims=dims(cfg, cell.workload, dtype, pool_dtype),
                 t0=t0, t1=t1, setup_s=setup_s, reqs=loop.reqs,
                 counters0=counters0, counters1=counters1,
                 steps=len(loop.step_ends) - n0, tracer=tracer,
                 trace=reduced, paused=paused)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, rec)
    attempted = sum(1 for r in loop.reqs if r.submit_t <= t1
                    and (r.done_t is None or r.done_t > t0))
    done = rec.completed()

    # the check: the program's state is freed first, and the reference
    # runs request by request beside the weights
    del loop, eng
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    chk = cell.workload["check"]
    picked = check.sample(done, seed, chk["served_tokens"])
    got, ctrl = check.numbers(params, conf, picked, device, control=control)
    limits = chk["limits"]
    correct = bool(picked) and all(
        lim is not None and got[k] <= lim for k, lim in limits.items())
    out = {"correct": correct,
           "attempted": attempted, "failed": 0, "metrics": metrics,
           "device": {"memory_peak_bytes": int(peak)},
           "checked": {"requests": len(picked),
                       "tokens": sum(len(r.tokens) for r in picked),
                       "completed_in_window": len(done),
                       "first_tokens_in_window": sum(
                           1 for r in rec.reqs
                           if r.times and rec.inside(r.times[0])),
                       "steps": rec.steps, "window_s": rec.window_s,
                       **{k: v for k, v in got.items() if k not in limits}},
           "setup": phases}
    if ctrl is not None:
        out["control"] = ctrl
    if tracer:
        from perfbench.trace import top
        out["device"].update(busy_s=reduced["busy_s"],
                             window_s=reduced["window_s"])
        out["breakdown"] = {"device_ops": top(reduced["kernels"]),
                            "idle_gaps": top(reduced["idle_gaps"])}
    out["checks"] = {k: {"value": got[k], "limit": lim}
                     for k, lim in limits.items()}
    return out
