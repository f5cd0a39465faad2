"""Op-level counterpart of ``repro.launch.hlo_analysis``: the roofline
terms of one eager step, counted op by op as it runs.

Eager PyTorch has no HLO to parse.  The dry run (``launch/dryrun.py``)
runs the step once on fake tensors, as one rank of a fake process group,
under the modes of :func:`analyze`, which watch every ATen op it
dispatches (autograd's backward and the remat recompute included):

* **flops** per rank from ``torch.utils.flop_counter.FlopCounterMode``:
  the matmuls (``mm``, ``bmm``, ``addmm``, the products an ``einsum``
  lowers to), 2 · |result| · |contraction| each, as the reference counts
  its ``dot``s (``hlo_analysis.py:150-170``);
* **HBM bytes** from :class:`ByteCounter`: 2 · |result| for every op
  that materialises a tensor (views and bare allocations are free), the
  update operand (2 · |update|) for the indexed in-place writes
  (``index_put_``, ``scatter_``, ``index_add_``, ...), 2 · payload for
  every collective (as the reference counts them; the tensor work a
  backend does inside the call, gloo's staging copies, is left out),
  plus the arguments (params, optimizer state, caches, batch) read
  once.  Unlike
  the reference, nothing is excluded as fused away: eager fuses nothing,
  and the count says what eager runs;
* **collectives** per kind (payload, count, ring wire bytes) from
  ``collectives.TRAFFIC``, each call's wire bytes by the reference's
  ring factors (``collectives.wire_factor``).  The payload is the
  port's message (a reduce-scatter's whole input; the reference's HLO
  counts its result shard);
* **memory** (argument, peak) from
  ``torch.distributed._tools.mem_tracker.MemTracker``: the storages
  alive when the step starts (its arguments) and the most alive at any
  op, rounded to the CUDA allocator's 512-byte blocks on a CUDA device,
  both on the device of the step's tensors (a 0-d CPU scalar beside
  them is not the card's).

Everything is per rank.  Hardware constants: H100 SXM5, NVIDIA's data
sheet: HBM3 3.35 TB/s; dense peaks 989 TFLOP/s bf16 (tensor cores) and
67 TFLOP/s f32 (CUDA cores), the one of the dtype the cell runs; NVLink
4 at 900 GB/s both ways per GPU (450 GB/s a direction) between the 8
GPUs of a node (DGX H100), and one 400 Gb/s NDR InfiniBand port per GPU
(50 GB/s a direction) between nodes.  A collective's wire bytes go at
NVLink's rate when its group lies inside one node of 8 consecutive
ranks, at InfiniBand's otherwise.  The record carries the constants it
used.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed import collectives as coll

HBM_BW = 3.35e12                 # bytes/s per GPU (H100 SXM5 HBM3)
PEAK_FLOPS = {torch.bfloat16: 989e12,    # dense, tensor cores
              torch.float32: 67e12}      # CUDA cores
NVLINK_BW = 450e9                # bytes/s a direction, inside a node
IB_BW = 50e9                     # bytes/s a direction, 400 Gb/s NDR
NODE_GPUS = 8
CONSTANTS_SOURCE = ("NVIDIA H100 SXM5 data sheet (HBM3 3.35 TB/s; dense "
                    "989 TFLOP/s bf16, 67 TFLOP/s f32; NVLink 4 900 GB/s "
                    "bidirectional); DGX H100: 8 GPUs a node, one 400 Gb/s "
                    "NDR InfiniBand port per GPU")

_aten = torch.ops.aten
#: in-place indexed writes: the op writes (and reads) its update operand,
#: not the whole destination — the argument position of that operand
_INDEXED = {
    _aten.index_put_.default: 2, _aten._index_put_impl_.default: 2,
    _aten.scatter_.src: 3, _aten.scatter_add_.default: 3,
    _aten.scatter_reduce_.two: 3, _aten.index_add_.default: 3,
    _aten.index_copy_.default: 3,
}
#: ops that make a tensor without writing it, or alias one without the
#: view flag in their schema
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default, _aten.alias.default,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """HBM traffic of the ops dispatched under it (the module doc's
    rules), in ``self.bytes``."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if coll.TRAFFIC.busy:            # a collective's own work
            return out
        if func in _INDEXED:
            upd = args[_INDEXED[func]] if len(args) > _INDEXED[func] else None
            if isinstance(upd, torch.Tensor):
                self.bytes += 2 * _nbytes(upd)
        elif not func.is_view and func not in _FREE:
            self.bytes += 2 * sum(_nbytes(t) for t in tree_flatten(out)[0]
                                  if isinstance(t, torch.Tensor))
        return out


@dataclass
class Roofline:
    """The reference's roofline record, per rank, with the H100 constants
    it was computed at.  ``collective_s`` comes from each call's own
    link (:func:`collective_seconds`)."""
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    chips: int
    peak_flops: float
    coll_s: float
    hbm_bw: float = HBM_BW

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_s": self.step_s,
            "constants": {"peak_flops": self.peak_flops,
                          "hbm_bw": self.hbm_bw, "nvlink_bw": NVLINK_BW,
                          "ib_bw": IB_BW, "node_gpus": NODE_GPUS,
                          "source": CONSTANTS_SOURCE},
        }


def group_in_node(ranks) -> bool:
    """Whether the ranks lie inside one node of NODE_GPUS consecutive
    ranks."""
    ranks = list(ranks)
    return min(ranks) // NODE_GPUS == max(ranks) // NODE_GPUS


def link_bw(ranks) -> float:
    """The rate a collective over ``ranks`` runs at: NVLink inside a
    node, InfiniBand across nodes."""
    return NVLINK_BW if group_in_node(ranks) else IB_BW


def collective_seconds(traffic) -> float:
    """Σ wire bytes / link rate over the groups of a ``Traffic``."""
    return sum(b * coll.wire_factor(k, len(r)) / link_bw(r)
               for (k, r), (_, b) in traffic.groups.items())


def collectives_record(traffic) -> dict:
    """The reference's ``collectives`` entry from a ``Traffic``."""
    kinds = traffic.by_kind()
    return {"payload_by_kind": {k: v["bytes"] for k, v in kinds.items()},
            "count_by_kind": {k: v["calls"] for k, v in kinds.items()},
            "wire_bytes_per_chip": traffic.wire_bytes,
            "calls": traffic.calls, "bytes": traffic.bytes}


def storage_bytes(tree, device, round_to: int = 1) -> int:
    """Bytes of the distinct storages under ``tree`` (a DTensor's local
    block) on ``device``, each rounded up to ``round_to``."""
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if not isinstance(t, torch.Tensor):
            continue
        if isinstance(t, DTensor):
            t = t.to_local()
        if t.device != device:
            continue
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        total += math.ceil(st.nbytes() / round_to) * round_to
    return total


def analyze(step, args: tuple, *, chips: int, dtype):
    """Run ``step(*args)`` once under the analysis modes → (Roofline,
    collectives record, memory dict).  The caller enters the
    ``FakeTensorMode`` (and starts the fake process group) the step runs
    in, if any."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    dev = next(t for t in tree_flatten(args)[0]
               if isinstance(t, torch.Tensor)).device
    rounding = 512 if dev.type == "cuda" else 1
    argument = storage_bytes(args, dev, round_to=rounding)
    coll.TRAFFIC.reset()
    mt = MemTracker()
    mt.track_external(*tree_flatten(args)[0])
    counter = ByteCounter()
    with mt, FlopCounterMode(display=False) as flops, counter:
        step(*args)
    peak = mt.get_tracker_snapshot("peak")[dev]["Total"]
    rl = Roofline(flops_per_chip=float(flops.get_total_flops()),
                  hbm_bytes_per_chip=float(counter.bytes + argument
                                           + 2 * coll.TRAFFIC.bytes),
                  coll_bytes_per_chip=coll.TRAFFIC.wire_bytes, chips=chips,
                  peak_flops=PEAK_FLOPS[dtype],
                  coll_s=collective_seconds(coll.TRAFFIC))
    mem = {"argument_bytes": argument, "peak_bytes": peak}
    return rl, collectives_record(coll.TRAFFIC), mem
