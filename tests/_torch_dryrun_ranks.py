"""The dry run's cells on four processes, for real and on fake tensors.
No JAX here.

    python tests/_torch_dryrun_ranks.py real RANK WORLD WORKDIR
    python tests/_torch_dryrun_ranks.py fake 0 1 WORKDIR

``tests/test_torch_dryrun.py`` writes the cells into
``WORKDIR/cells.json`` (a smoke config or a dict of config fields, a cut
shape, and a (data, model) mesh, (2, 2) unless the cell names one).  ``real``: one of
WORLD gloo CPU ranks (a file store under WORKDIR) runs each cell's
``build_cell`` step on real tensors under ``op_analysis.analyze``.
``fake``: one process stands as rank 0 of a fake process group of 4
ranks and runs the same cells through ``run_cell`` on meta tensors.
Both build each cell's host mesh.  Rank 0 writes
``<mode>.json``: per cell its record, or the traceback.
"""

from __future__ import annotations

import json
import math
import sys
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, get_smoke
from repro_torch.distributed import collectives as coll
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import AttnConfig, ModelConfig

MESH = (2, 2)


def config(c: dict) -> ModelConfig:
    """The cell's ``cfg`` (ModelConfig fields, ``attn`` a dict of
    AttnConfig's), or its arch's smoke config."""
    if "cfg" not in c:
        return get_smoke(c["arch"])
    spec = dict(c["cfg"])
    if isinstance(spec.get("attn"), dict):
        spec["attn"] = AttnConfig(**spec["attn"])
    return ModelConfig(**spec)


def cell_kw(c: dict, device: str = "cpu") -> dict:
    return dict(cfg=config(c), shape=ShapeSpec(**c["shape"]),
                device=device)


def real(c: dict, mesh) -> dict:
    torch.manual_seed(0)
    step, args, meta = dryrun.build_cell(c["arch"], c["shape"]["name"],
                                         mesh=mesh, **cell_kw(c))
    return dryrun.analyze_cell(step, args, meta)


def fake(c: dict, mesh) -> dict:
    return dryrun.run_cell(c["arch"], c["shape"]["name"], mesh=mesh,
                           verbose=False, **cell_kw(c, "meta"))


def main() -> None:
    torch.set_num_threads(1)
    mode, rank, world, work = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    with open(f"{work}/cells.json") as f:
        cells = json.load(f)
    if mode == "real":
        dist.init_process_group(
            "gloo", init_method=f"file://{work}/rendezvous", rank=rank,
            world_size=world, timeout=timedelta(seconds=120))
    else:
        dryrun.fake_world(math.prod(MESH))
    meshes = {}
    for c in cells.values():                 # every rank builds each once
        shape = tuple(c.get("mesh", MESH))
        if shape not in meshes:
            meshes[shape] = make_host_mesh(*shape, device_type="cpu")
            coll.make_groups(meshes[shape])
    out = {}
    for name, c in cells.items():
        mesh = meshes[tuple(c.get("mesh", MESH))]
        try:
            out[name] = {"ok": True,
                         "value": (real if mode == "real" else fake)(c, mesh)}
        except Exception:
            out[name] = {"ok": False, "error": traceback.format_exc()}
    if rank == 0:
        with open(f"{work}/{mode}.json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
