"""Atomic, sharded, elastic checkpoint manager with the reference's format.

PyTorch counterpart of ``repro.training.checkpoint``; a checkpoint
written by either package restores in the other:

* **Atomic**: staged in ``step_<n>.tmp`` and ``os.replace``d into place.
* **Format**: ``manifest.json`` (step, and per leaf its shape, dtype and
  shard index ranges) plus ``shards.npz`` holding ``<key>::<i>`` arrays.
  Keys are the reference's flattened paths (``params/body/0/mix/wq``),
  and body leaves are stored stacked over their blocks, as the reference
  keeps them: each block is its own shard of the stacked leaf.
* **Sharded**: a DTensor leaf is saved per shard with its global index
  (``distributed/elastic.py``); every rank's entries are gathered to
  rank 0, which writes the checkpoint, and all ranks then pass a
  barrier.  A plain tensor is one shard covering it.
* **Elastic**: restore reassembles leaves by index math and, given a
  mesh and specs, places them onto that mesh, whatever mesh saved them.
* **Async**: ``save(..., blocking=False)`` copies to the host, then
  writes on a background thread.
* **Retention**: keeps the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.bridge import from_numpy, leaves, map_leaves
from repro_torch.distributed.elastic import assemble, reshard, shard_entries


def _entries(tree) -> dict:
    """{key: [shape, dtype or None, [(index, data), ...]]} of this rank's
    shards, keyed and indexed as the reference's stacked leaves."""
    out: dict = {}

    def collect(key, block, t):
        shape = list(t.shape)
        if block is not None:
            shape = [block + 1] + shape
        meta = out.setdefault(key, [shape, None, []])
        meta[0] = [max(a, b) for a, b in zip(meta[0], shape)]
        for idx, data in shard_entries(t):
            if block is not None:
                idx, data = ((block, block + 1),) + idx, data[None]
            meta[1] = str(data.dtype)
            meta[2].append((idx, data))

    map_leaves(collect, tree)
    return out


def _merge(per_rank: list) -> dict:
    out: dict = {}
    for entries in per_rank:
        for key, (shape, dtype, shards) in entries.items():
            meta = out.setdefault(key, [shape, None, []])
            meta[1] = meta[1] or dtype
            meta[2] += shards
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = True) -> str:
        # snapshot to host *now* (the caller updates its tensors in place)
        entries = _entries(tree)
        sharded = any(isinstance(t, DTensor) for t in leaves(tree))
        if sharded:
            per_rank = [None] * dist.get_world_size()
            dist.gather_object(entries, per_rank if dist.get_rank() == 0
                               else None, dst=0)
            if dist.get_rank() != 0:
                dist.barrier()
                return os.path.join(self.dir, f"step_{step}")
            entries = _merge(per_rank)
        manifest = {"step": step, "leaves": {}}
        payload: dict[str, np.ndarray] = {}
        for key, (shape, dtype, shards) in entries.items():
            manifest["leaves"][key] = {
                "shape": shape, "dtype": dtype,
                "shards": [list(map(list, idx)) for idx, _ in shards]}
            for i, (_, data) in enumerate(shards):
                payload[f"{key}::{i}"] = data

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shards.npz"), **payload)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)             # atomic publish
            self._gc()

        if blocking or sharded:             # the other ranks wait for it
            _write()
            if sharded:
                dist.barrier()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        return os.path.join(self.dir, f"step_{step}")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore_host(self, step: int) -> tuple[dict, int]:
        """Load flat {path: np.ndarray} for a step (mesh-agnostic)."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        z = np.load(os.path.join(d, "shards.npz"))
        flat = {}
        for key, meta in manifest["leaves"].items():
            dtype = _dtype(meta["dtype"])
            # npz keeps bfloat16 as 2-byte voids: view them back (the
            # reference's own restore cannot read them)
            entries = [(tuple(map(tuple, idx)), z[f"{key}::{i}"].view(dtype))
                       for i, idx in enumerate(meta["shards"])]
            flat[key] = assemble(tuple(meta["shape"]), dtype, entries)
        return flat, manifest["step"]

    def restore(self, step: int, like_tree, mesh=None, specs=None):
        """Restore into the structure of ``like_tree`` (the port's layout),
        each leaf on its like's device with the checkpoint's dtype; with
        a ``DeviceMesh`` and a tree of specs, as DTensors placed on that
        mesh (``elastic.reshard``)."""
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, "
                            f"got {type(mesh).__name__}")
        if (mesh is None) != (specs is None):
            raise ValueError("restoring onto a mesh takes both mesh and "
                             "specs")
        flat, _ = self.restore_host(step)
        keys = set()
        map_leaves(lambda key, _b, _x: keys.add(key), like_tree)
        missing = keys - set(flat)
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
        host = map_leaves(lambda key, b, _like: flat[key] if b is None
                          else flat[key][b], like_tree)
        if mesh is not None:
            return reshard(host, mesh, specs)
        return map_leaves(lambda key, b, x, like: from_numpy(x, like.device),
                          host, like_tree)


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)
