"""Multi-pod dry run: every (arch × shape × mesh) cell's step, run once on
fake tensors as rank 0 of a 256- or 512-rank fake process group.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's jitted step for the 16×16 = 256-chip pod mesh and
the 2×16×16 = 512-chip multi-pod mesh and reads the compiled artifact's
memory and cost analyses.  Eager PyTorch compiles nothing, so the port
runs the step itself: one process stands as rank 0 of a process group
of torch's ``"fake"`` backend (collectives that move nothing) over
``make_production_mesh``, every tensor a ``FakeTensor`` (shape, dtype
and device, no storage), and ``launch/op_analysis.py`` counts what the
rank would run: FLOPs, HBM bytes, collectives by kind and the memory
peak (zero allocation).  The step is the port's own entry point:

    train    ``make_train_step(cfg, tc, mesh)`` on params, AdamW moments
             and error state sharded by ``param_specs`` (bf16 params;
             the reference's microbatches, ``moe_groups = n_dp``, bf16
             moments and accumulator for ``TRAIN_LOWMEM``)
    prefill  ``transformer.prefill(layout=...)`` from the rank's blocks
             under ``param_specs`` (bf16, ``sharding.shard_params``), as
             the reference serves under ``psh``: the rank's batch rows of
             the tokens, patches and frames over ``decode_axes``' batch
             axes, bf16 caches whose pools are the rank's rows
             (``cache_spec(..., round_to=shards)``) and whose other keys
             are its rows and shares (``collectives.local_state(
             layout=)``); MoE layers route ``n_dp`` groups, as the
             reference's
    decode   ``transformer.decode_step(page_impl="sp"|"sp_opt",
             layout=...)`` over the same blocks and caches, SWA models
             over the ring pool of their window; MoE layers route one
             group

One JSON a cell goes to ``build/dryrun/`` (``--out``), with the
reference's keys (``fits_hbm_80g`` for the H100's 80 GB in place of
``fits_hbm_16g``; no ``cpu_scatter_artifact_bytes``, an XLA:CPU artifact
the port does not have).  A cell whose step raises is recorded with the
error and the frame of the port that raised it, and the sweep exits 1.

``page_impl`` takes ``"sp"`` or ``"sp_opt"`` only: the reference's
``"ref"`` and ``"pallas"`` run unsharded, and ``decode_step`` refuses
them on a mesh.  ``moe_groups`` overrides every cell's routing groups.

Two kinds of stand-in tensor, picked by ``device`` (default
:data:`DEVICE`): fake CUDA tensors under ``FakeTensorMode`` where torch
is built with CUDA, else ``meta`` tensors (a CPU-only build cannot
index a fake CUDA tensor).  Both hold no storage, and every count is the
same on both but for one: ``MemTracker`` rounds a CUDA storage up to the
caching allocator's 512-byte blocks, as the card's ``memory_allocated``
counts it, and a meta storage not at all.  So ``chip_smoke.py``'s phase
12 (a), which holds the memory against the card's allocator, runs fake
CUDA tensors; meta tensors skip ``FakeTensorMode`` and run two to three
times faster, so the production cell runs on them.  ``build_cell``
outside :func:`run_cell` makes real tensors (``device="cpu"``), which
``tests/test_torch_dryrun.py`` runs on real gloo ranks against the meta
run.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, LONG_CONTEXT_ARCHS, SHAPES,
                                 ShapeSpec, get_config)
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shard_rules
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
DEVICE = "cuda" if torch.backends.cuda.is_built() else "meta"
#: the H100's device memory a rank's peak must stay under
HBM_BYTES = 80e9

#: SWA archs keep only the window resident (FPR ring recycling) — the pool
#: is sized to the window, not the table capacity.
SWA_POOL = True

#: per-arch train_4k microbatch counts (the reference's: activation-memory
#: fit at 16 GB/chip; the default B//32 = 8 suits the ≤16B dense models)
TRAIN_MICROBATCHES = {
    # microbatch rows must stay ≥ the data-parallel shard count (16)
    "deepseek-v2-236b": 16,
    "jamba-v0.1-52b": 16,
    "internvl2-26b": 16,
    "qwen2.5-14b": 16,
}
#: ≥100B models: bf16 Adam moments + bf16 grad accumulation (6 B/param of
#: optimizer+accumulator state instead of 12)
TRAIN_LOWMEM = {"deepseek-v2-236b"}


# ============================================================== input specs
def input_specs(arch: str, shape_name: str, *, cfg: ModelConfig | None = None,
                shape: ShapeSpec | None = None) -> dict:
    """``{name: (shape, dtype)}`` of every model input of this cell."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B,), torch.int32)}
    d = {"tokens": ((B, S), torch.int32)}
    if shape.kind == "train":
        d["labels"] = ((B, S), torch.int32)
    if cfg.frontend == "vision":
        d["patches"] = ((B, cfg.prefix_tokens, cfg.d_model), torch.bfloat16)
    if cfg.enc_dec:
        d["frames"] = ((B, cfg.enc_len, cfg.d_model), torch.bfloat16)
    return d


def state_specs(cfg: ModelConfig, shape: ShapeSpec, shards: int,
                m_round: int = 1, dtype=torch.bfloat16) -> dict:
    """``{key: (shape, dtype)}`` of the whole decode state of this cell
    (caches in ``dtype``: bf16, as the reference's, in every production
    cell)."""
    B, S = shape.global_batch, shape.seq_len
    extra = cfg.prefix_tokens if cfg.frontend == "vision" else 0
    max_len = S + extra + tfm.BLOCK_SIZE          # one block of decode slack
    if m_round > 1:                                # sp_opt: M divisible by
        bs = tfm.BLOCK_SIZE                        # the seq-shard count
        M = -(-max_len // bs)
        max_len = (-(-M // m_round) * m_round) * bs
    num_blocks = None
    if cfg.attn.window is not None and SWA_POOL and shape.kind == "decode":
        per_seq = (cfg.attn.window + tfm.BLOCK_SIZE - 1) // tfm.BLOCK_SIZE + 2
        num_blocks = B * per_seq
    return tfm.cache_spec(cfg, B, max_len, num_blocks=num_blocks,
                          dtype=dtype, round_to=shards)


# ============================================================ process group
def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake process group of ``n`` ranks,
    ending a fake group of another size first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group is running: pass its "
                f"mesh to build_cell instead")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh_device(device: str) -> str:
    """A mesh's device type for tensors on ``device`` (a DeviceMesh has
    no meta type; a CPU mesh holds meta tensors)."""
    return "cpu" if device == "meta" else device


def _size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _zeros(specs: dict, device) -> dict:
    return {k: torch.zeros(sh, dtype=dt, device=device)
            for k, (sh, dt) in specs.items()}


# ============================================================ cell building
def _serving_layout(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    page_impl: str, dtype):
    """(batch axes, seq axes, whole state specs) of a serving cell, its
    caches in ``dtype`` (the params')."""
    ba, sa = shard_rules.decode_axes(mesh, batch=shape.global_batch)
    n_seq = _size(mesh, sa)
    return ba, sa, state_specs(cfg, shape, _size(mesh, ba + sa),
                               m_round=n_seq if page_impl == "sp_opt" else 1,
                               dtype=dtype)


def cell_meta(arch: str, shape: ShapeSpec, cfg: ModelConfig, mesh, *,
              multi_pod: bool = False, page_impl: str = "sp",
              microbatches: int | None = None,
              moe_groups: int | None = None,
              param_dtype=torch.bfloat16) -> dict:
    """The record's fields that the cell's config, shape and mesh fix,
    with no tensor made (``mesh``: anything with ``mesh_dim_names`` and
    ``shape``): the reference's microbatches of a train cell and MoE
    groups of every cell (``n_dp`` for train and prefill, 1 for decode,
    unless ``moe_groups`` is given), the decode layout and pool bytes a
    rank of a serving cell, tokens a step and the parameter counts."""
    if page_impl not in tfm.SP_IMPLS:
        raise ValueError(f"page_impl must be one of {tfm.SP_IMPLS} on a "
                         f"mesh (decode_step refuses the others), got "
                         f"{page_impl!r}")
    sizes = axis_sizes(mesh)
    B, S = shape.global_batch, shape.seq_len
    n_dp = _size(mesh, shard_rules.dp_axes(mesh))
    groups = moe_groups if moe_groups is not None else (
        1 if shape.kind == "decode" else n_dp)
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "mesh": list(sizes.values()), "mesh_axes": list(sizes),
            "chips": math.prod(sizes.values()), "multi_pod": multi_pod,
            "page_impl": page_impl, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "dtype": str(param_dtype).removeprefix("torch.")}
    if shape.kind == "train":
        mb = microbatches or TRAIN_MICROBATCHES.get(arch, max(1, B // 32))
        meta.update(microbatches=min(mb, max(1, B // n_dp)),  # rows ≥ dp
                    moe_groups=groups, tokens_per_step=B * S)
        return meta
    ba, sa, st_specs = _serving_layout(cfg, shape, mesh, page_impl,
                                       param_dtype)
    pool_global = sum(math.prod(st_specs[k][0]) * st_specs[k][1].itemsize
                      for k in coll.POOL_KEYS if k in st_specs)
    meta.update(pool_bytes_per_chip=pool_global // _size(mesh, ba + sa),
                batch_axes=list(ba), seq_axes=list(sa), moe_groups=groups,
                tokens_per_step=B * S if shape.kind == "prefill" else B)
    return meta


def build_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               page_impl: str = "sp", attn_impl: str = "chunked",
               microbatches: int | None = None,
               moe_groups: int | None = None, compress_grads: bool = False,
               param_dtype=torch.bfloat16, mesh=None,
               cfg: ModelConfig | None = None, shape: ShapeSpec | None = None,
               device: str = DEVICE):
    """Returns ``(step, args, meta)`` for one cell: ``step(*args)`` runs
    the cell's step on this rank.  Tensors are made on ``device`` in
    whatever mode the caller is in: under ``FakeTensorMode`` (as
    :func:`run_cell` calls it for ``"cuda"``) or on ``"meta"`` nothing
    is allocated; on ``"cpu"`` outside any fake mode the same cell runs
    for real (the tests hold the two against each other).

    ``mesh`` defaults to ``make_production_mesh(multi_pod=...)`` over the
    running process group (made outside any fake mode, as is every
    process group of its dims: ``collectives.make_groups``); ``cfg`` and
    ``shape`` replace the registry's config and shape (a cut model, a
    smaller batch)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device_type=_mesh_device(device))
    coll.make_groups(mesh)
    meta = cell_meta(arch, shape, cfg, mesh, multi_pod=multi_pod,
                     page_impl=page_impl, microbatches=microbatches,
                     moe_groups=moe_groups, param_dtype=param_dtype)
    meta["device"] = device
    B = shape.global_batch
    params = tfm.init_params(cfg, generator=None, device=device,
                             dtype=param_dtype)

    if shape.kind == "train":
        from repro_torch.training.optimizer import AdamWConfig
        from repro_torch.training.train_loop import (TrainConfig,
                                                     make_train_step,
                                                     shard_state)
        lowmem = arch in TRAIN_LOWMEM
        tc = TrainConfig(
            microbatches=meta["microbatches"], attn_impl=attn_impl,
            moe_groups=meta["moe_groups"], compress_grads=compress_grads,
            accum_dtype="bfloat16" if lowmem else "float32",
            adamw=AdamWConfig(
                moments_dtype="bfloat16" if lowmem else "float32"))
        params, opt, err = shard_state(params, None, tc, mesh)
        batch = _zeros(input_specs(arch, shape.name, cfg=cfg, shape=shape),
                       device)
        return make_train_step(cfg, tc, mesh), (params, opt, err,
                                                batch), meta

    from repro_torch.distributed.parallel import Layout, shapes_of
    specs = shard_rules.param_specs(params, mesh)
    blocks = shard_rules.shard_params(params, mesh, specs)
    del params
    layout = Layout(cfg, mesh, specs, shapes_of(blocks))
    params = shard_rules.local_blocks(blocks)
    ba, sa, st_specs = _serving_layout(cfg, shape, mesh, page_impl,
                                       param_dtype)
    state = _zeros({k: v for k, v in st_specs.items() if k != "tables"},
                   device)
    state["tables"] = _tables(st_specs, B, _size(mesh, ba), _size(mesh, sa),
                              device)
    if shape.kind == "decode":
        state["lengths"].fill_(shape.seq_len)
    state = coll.local_state(state, cfg, mesh, batch_axes=ba, seq_axes=sa,
                             layout=layout)
    kw = dict(batch_axes=ba, seq_axes=sa, moe_groups=meta["moe_groups"],
              layout=layout)

    def rows(x):                        # the rank's batch rows, a copy
        return coll.local_shard(x, (ba,), mesh).clone()

    if shape.kind == "prefill":
        inp = {k: rows(v) for k, v in _zeros(
            input_specs(arch, shape.name, cfg=cfg, shape=shape),
            device).items()}

        def prefill_step(params, tokens, state, extras):
            return tfm.prefill(params, cfg, tokens, state,
                               enc_frames=extras.get("frames"),
                               patches=extras.get("patches"), **kw)

        extras = {k: v for k, v in inp.items() if k != "tokens"}
        return prefill_step, (params, inp["tokens"], state, extras), meta

    def serve_step(params, state, tokens):
        return tfm.decode_step(params, cfg, state, tokens,
                               page_impl=page_impl, **kw)

    tokens = rows(torch.zeros((B,), dtype=torch.int32, device=device))
    return serve_step, (params, state, tokens), meta


def _tables(st_specs: dict, B: int, batch_shards: int, seq_shards: int,
            device) -> torch.Tensor:
    """The block tables: the identity layout of the sharded pool where it
    fits, else (an SWA ring pool smaller than the table) all holes.  No
    shape the step makes depends on them."""
    (_, M), _ = st_specs["tables"]
    pool = st_specs.get("kv", st_specs.get("mla_c"))
    N = pool[0][1] if pool else B * M
    Nl = N // (batch_shards * seq_shards)
    if (B // batch_shards) * -(-M // seq_shards) > Nl:
        return torch.full((B, M), -1, dtype=torch.int32, device=device)
    return tfm.sp_identity_tables(B, M, N, batch_shards, seq_shards, device)


# ================================================================ analysis
def analyze_cell(step, args, meta: dict, param_dtype=torch.bfloat16) -> dict:
    """Run the built cell under ``op_analysis`` → the cell's record."""
    t0 = time.time()
    rl, colls, mem = op_analysis.analyze(step, args, chips=meta["chips"],
                                         dtype=param_dtype)
    # MODEL_FLOPS: 6·N_active·D train, 2·N_active·D serve (a step, global)
    factor = 6 if meta["kind"] == "train" else 2
    model_flops = factor * meta["active_params"] * meta["tokens_per_step"]
    op_global = rl.flops_per_chip * meta["chips"]
    rec = dict(meta)
    rec.update({
        "roofline": rl.as_dict(),
        "collectives": colls,
        "memory": mem,
        "model_flops": model_flops,
        "op_flops_global": op_global,
        "useful_flops_ratio": model_flops / op_global if op_global else None,
        "run_s": time.time() - t0,
        "fits_hbm_80g": mem["peak_bytes"] < HBM_BYTES,
    })
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             page_impl: str = "sp", out_dir: str | None = None,
             verbose: bool = True, mesh=None, device: str = DEVICE,
             **kw) -> dict:
    """Build and analyse one cell on fake CUDA tensors (``device="cuda"``)
    or meta tensors (``"meta"``); with no ``mesh``, as rank 0 of a fake
    group of the production mesh's size (started here).
    Writes ``<out_dir>/<arch>_<shape>_<sp|mp>[_<page_impl>].json``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if device not in ("cuda", "meta"):
        raise ValueError(f"run_cell runs on fake CUDA or meta tensors, got "
                         f"device={device!r} (build_cell makes real ones)")
    if mesh is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=_mesh_device(device))
    coll.make_groups(mesh)        # the mesh's tensor ops run for real
    t0 = time.time()
    with (FakeTensorMode() if device == "cuda"
          else contextlib.nullcontext()):
        step, args, meta = build_cell(arch, shape_name, multi_pod=multi_pod,
                                      page_impl=page_impl, mesh=mesh,
                                      device=device, **kw)
        t1 = time.time()
        rec = analyze_cell(step, args, meta,
                           kw.get("param_dtype", torch.bfloat16))
    rec["build_s"] = t1 - t0
    if verbose:
        rl, mem = rec["roofline"], rec["memory"]
        print(f"[{arch} × {shape_name} × "
              f"{'multi' if multi_pod else 'single'}-pod]  "
              f"compute {rl['compute_s']*1e3:.2f}ms  "
              f"memory {rl['memory_s']*1e3:.2f}ms  "
              f"collective {rl['collective_s']*1e3:.2f}ms  "
              f"← {rl['bottleneck']}; "
              f"peak {mem['peak_bytes']/1e9:.2f} GB/chip "
              f"(fits 80 GB: {rec['fits_hbm_80g']})  "
              f"(build {rec['build_s']:.0f}s run {rec['run_s']:.0f}s)",
              flush=True)
    if out_dir:
        _write(out_dir, arch, shape_name, multi_pod, page_impl, rec)
    return rec


def _write(out_dir, arch, shape_name, multi_pod, page_impl, rec) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}_{shape_name}_{'mp' if multi_pod else 'sp'}"
    if page_impl != "sp":
        tag += f"_{page_impl}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def failure_record(arch, shape_name, multi_pod, page_impl, exc) -> dict:
    """The record of a cell whose step raised: the error and the
    innermost frame of the port (the op or leaf that stopped it)."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename]
    where = (f"{Path(frames[-1].filename).name}:{frames[-1].lineno} "
             f"{frames[-1].line}" if frames else None)
    return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "page_impl": page_impl, "error": repr(exc), "where": where}


def iter_cells(multi_pod: bool):
    for a in ARCH_IDS:
        for s in SHAPES.values():
            if s.name == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                continue
            yield a, s.name


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--page-impl", default="sp", choices=list(tfm.SP_IMPLS))
    ap.add_argument("--microbatches", type=int)
    ap.add_argument("--moe-groups", type=int)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args()

    kw = dict(page_impl=args.page_impl, out_dir=args.out,
              microbatches=args.microbatches, moe_groups=args.moe_groups,
              compress_grads=args.compress_grads)
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    cells = (list(iter_cells(args.multi_pod)) if args.all
             else [(args.arch, args.shape)])
    failures = []
    for mp in meshes:
        for arch, shape in cells:
            try:
                run_cell(arch, shape, multi_pod=mp, **kw)
            except Exception as e:
                traceback.print_exc()
                rec = failure_record(arch, shape, mp, args.page_impl, e)
                failures.append(rec)
                _write(args.out, arch, shape, mp, args.page_impl, rec)
    if failures:
        print(f"\n{len(failures)} FAILED cells:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} cells ran OK")


if __name__ == "__main__":
    main()
