"""Atomic, sharded checkpoint manager with the reference's on-disk format.

PyTorch counterpart of ``repro.training.checkpoint``; a checkpoint
written by either package restores in the other:

* **Atomic**: staged in ``step_<n>.tmp`` and ``os.replace``d into place.
* **Format**: ``manifest.json`` (step, and per leaf its shape, dtype and
  shard index ranges) plus ``shards.npz`` holding ``<key>::<i>`` arrays.
  Keys are the reference's flattened paths (``params/body/0/mix/wq``),
  and body leaves are stored stacked over their blocks, as the reference
  keeps them (:func:`repro_torch.bridge.params_to_jax`).  The port runs
  on one device, so each leaf is one shard covering the whole array; a
  reference checkpoint's shards of any mesh are reassembled on restore.
* **Async**: ``save(..., blocking=False)`` copies to the host, then
  writes on a background thread.
* **Retention**: keeps the newest ``keep`` checkpoints.

Restoring onto a mesh (the reference's ``reshard``) needs the port's
distributed slice and raises here.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np

from repro_torch.bridge import from_numpy, map_leaves, params_to_jax

_SEP = "/"


def shard_entries(arr: np.ndarray):
    """Yield (index_tuple, host_ndarray) per shard: one device, so one
    entry covering the whole array."""
    yield tuple((0, dim) for dim in arr.shape), arr


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


def _flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of a reference-layout tree (dicts and tuples), paths
    joined as the reference's ``_flatten`` joins them."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = True) -> str:
        # snapshot to host *now* (the caller updates its tensors in place)
        flat = _flatten(params_to_jax(tree))
        manifest = {"step": step, "leaves": {}}
        payload: dict[str, np.ndarray] = {}
        for key, arr in flat.items():
            entries = list(shard_entries(arr))
            manifest["leaves"][key] = {
                "shape": list(arr.shape), "dtype": str(arr.dtype),
                "shards": [list(map(list, idx)) for idx, _ in entries]}
            for i, (_, data) in enumerate(entries):
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

        if blocking:
            _write()
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
        each leaf on its like's device with the checkpoint's dtype."""
        if mesh is not None or specs is not None:
            raise NotImplementedError(
                "restoring onto a mesh needs the port's distributed/ slice "
                "(ROADMAP Queue 1 item 4)")
        flat, _ = self.restore_host(step)
        keys = set()
        map_leaves(lambda key, _b, _x: keys.add(key), like_tree)
        missing = keys - set(flat)
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
        return map_leaves(
            lambda key, b, like: from_numpy(
                flat[key] if b is None else flat[key][b], like.device),
            like_tree)


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)
