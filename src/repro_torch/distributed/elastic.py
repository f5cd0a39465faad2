"""Elastic checkpoint resharding: restore any checkpoint onto any mesh.

Counterpart of ``repro.distributed.elastic``.  Checkpoints are saved
*per shard* (``training/checkpoint.py``): every leaf is stored as one
entry per shard with its global index (start, stop per dim).  Restore
reassembles leaves into host arrays by index math — the saving and
restoring meshes need not agree in shape, dim names, rank count or specs
— then places them with the *new* mesh's placements.  A checkpoint the
port writes restores in the reference and the reverse.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from repro_torch.bridge import from_numpy, map_leaves, to_numpy
from repro_torch.distributed.sharding import P, to_placements


def shard_index(shape, placements, coordinate, mesh_shape) -> tuple:
    """Global ((start, stop), ...) of the shard at ``coordinate`` of a
    tensor of ``shape`` under ``placements``: DTensor's split, one mesh
    dim after another (``torch.chunk`` sizes, so a short last shard)."""
    idx = [[0, n] for n in shape]
    for p, c, n in zip(placements, coordinate, mesh_shape):
        if isinstance(p, Shard):
            start, stop = idx[p.dim]
            step = -(-(stop - start) // n)
            idx[p.dim] = [min(stop, start + c * step),
                          min(stop, start + (c + 1) * step)]
        elif not isinstance(p, Replicate):
            raise ValueError(f"cannot save a {p} placement (reduce it "
                             f"first)")
    return tuple(map(tuple, idx))


def shard_entries(t: torch.Tensor):
    """Yield (index_tuple, host_ndarray) for this rank's shard of ``t``: a
    DTensor's local shard at its global index, yielded only by the rank at
    coordinate 0 on every ``Replicate`` dim (a replica is saved once); a
    plain tensor whole."""
    if not isinstance(t, DTensor):
        yield tuple((0, n) for n in t.shape), to_numpy(t)
        return
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    if coord is None:                         # not a member of the mesh
        return
    if any(c and isinstance(p, Replicate)
           for p, c in zip(t.placements, coord)):
        return
    yield (shard_index(t.shape, t.placements, coord, mesh.shape),
           to_numpy(t.to_local()))


def assemble(shape, dtype, entries) -> np.ndarray:
    """Rebuild the global array from (index, data) shard entries."""
    out = np.zeros(shape, dtype=dtype)
    covered = np.zeros(shape, dtype=bool) if entries else None
    for idx, data in entries:
        sl = tuple(slice(a, b) for a, b in idx)
        out[sl] = data
        covered[sl] = True
    if covered is not None and not covered.all():
        raise ValueError("checkpoint shards do not cover the global array "
                         "(missing ranks?)")
    return out


def reshard(host_tree, mesh, specs):
    """Place whole host arrays onto ``mesh`` as DTensors with the given
    specs (trees in the port's layout; a body block's tensor drops its
    spec's stack entry).  Every rank holds the host arrays, as the
    reference's ``device_put`` from host does, so each keeps its own
    shard and nothing is scattered."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))

    def place(key, block, x, spec):
        spec = spec if block is None else P(*spec[1:])
        return distribute_tensor(from_numpy(x, device), mesh,
                                 to_placements(spec, mesh),
                                 src_data_rank=None)

    return map_leaves(place, host_tree, specs)
