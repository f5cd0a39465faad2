"""Device meshes over ``torch.distributed``, with the reference's dim names.

Counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialised default process group, one process per mesh member (SPMD:
every process runs the same entry point on its own shards).  The dims
are named as in the reference: ``("data", "model")``, and ``("pod",
"data", "model")`` on multi-pod.  Functions, not constants: importing
this module touches no process group.

The reference's ``mesh_axis_kwargs`` has no counterpart: it papers over
a JAX version difference (``jax.sharding.AxisType``), and a DeviceMesh
has no axis types.  For the same reason the reference's
``distributed/_compat.py`` (``shard_map``, ``pvary`` across JAX
releases) has none either.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def axis_sizes(mesh) -> dict[str, int]:
    """``{dim name: size}`` in mesh-dim order: what the reference reads as
    ``mesh.axis_names`` and ``mesh.shape[a]``.  Anything with
    ``mesh_dim_names`` and ``shape`` will do (a DeviceMesh, or a stand-in
    for rules that read only shapes)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _mesh(device_type: str, shape: tuple, names: tuple) -> DeviceMesh:
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for a {names} mesh of shape {shape}, have "
            f"{world} (start one process per mesh member and initialise "
            f"torch.distributed first)")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16 × 16 = 256 GPUs per pod; 2 pods = 512 GPUs multi-pod
    (``device_type="cpu"`` for the dry run's meta tensors)."""
    if multi_pod:
        return _mesh(device_type, (2, 16, 16), ("pod", "data", "model"))
    return _mesh(device_type, (16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small ``("data", "model")`` mesh over the first ``data · model``
    ranks, for tests (``device_type="cpu"``) and single-host runs."""
    return _mesh(device_type, (data, model), ("data", "model"))
