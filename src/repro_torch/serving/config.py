"""Unified serving-engine configuration (port of ``repro.serving.config``).

``Engine.__init__`` had grown ~14 loose keyword arguments spanning four
layers (model paging, fence scoping, worker routing, admission control).
:class:`EngineConfig` is the single validated carrier; the one-release
loose-kwargs compatibility window has closed — ``Engine(cfg, params,
config=EngineConfig(...))`` is the only construction path and stray
keyword arguments raise ``TypeError``.

The config object is deliberately *data only*: the engine still builds the
cache, governor and evictor itself — configuration and wiring stay
separate.  ``num_workers`` is the *initial* topology;
:meth:`~repro_torch.serving.engine.Engine.resize_workers` reshards a live
engine and swaps in ``config.replace(num_workers=n)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.core.config import ConfigBase, validate_worker_count
from repro_torch.core.contexts import ContextScope
from repro_torch.core.eviction import Watermarks
from repro_torch.models.transformer import PAGE_IMPLS
from repro_torch.serving.admission import GovernorConfig

WORKER_ROUTINGS = ("slot", "stream")


@dataclass(frozen=True)
class EngineConfig(ConfigBase):
    """Validated configuration of a :class:`~repro_torch.serving.engine.Engine`.

    ``admission`` accepts ``None`` (legacy fill-every-slot scheduling), a
    policy name (``"fcfs"`` / ``"recycle"`` / ``"priority"`` /
    ``"deadline"``) or a full :class:`GovernorConfig`.
    """

    num_blocks: int = 256
    max_batch: int = 8
    max_seq_len: int = 512
    fpr_enabled: bool = True
    scope: ContextScope = ContextScope.PER_GROUP
    # "kernel": the CUDA paged-attention kernels (their plain versions on
    # the CPU); "ref": the gather oracle, asked for explicitly
    page_impl: str = "kernel"
    dtype: Any = torch.float32
    device: Any = "cuda"
    watermarks: Optional[Watermarks] = None
    eos_token: Optional[int] = None
    greedy: bool = True
    num_workers: int = 1
    # Hierarchical island topology: a tuple of worker-id tuples
    # partitioning range(num_workers) into islands (hosts / NUMA
    # domains) for two-level scoped fences; None / flat single-island
    # keeps the pre-island engine bit for bit.  Engine.reshape swaps in
    # a new partition on a live engine.
    islands: "tuple | None" = None
    scoped_fences: bool = True
    worker_routing: str = "slot"
    cost_model: Any = None
    admission: "GovernorConfig | str | None" = field(default=None)
    # Prefix sharing: admit common-prefix prompts onto the same physical
    # blocks (copy-on-write on divergence).  Only active under
    # ``fpr_enabled`` — see repro_torch.core.prefix.
    prefix_sharing: bool = True
    # Chunked prefill: admit a request when its *first* prefill chunk
    # (``prefill_chunk`` blocks, plus one active tail block) fits, run one
    # fixed-shape chunk per engine step interleaved with decode, and grow
    # the reservation chunk-by-chunk through the governor's
    # ``on_extend``/§IV-A allocation path.  Attention-only decoder models
    # (the engine falls back to monolithic prefill otherwise).
    chunked_prefill: bool = False
    prefill_chunk: int = 2             # blocks per prefill chunk
    # Ragged fused-KV serving: fold every slot's incoming tokens —
    # prefill chunks and decode rows alike — into ONE ragged kernel call
    # per attention layer per engine step (the tile descriptor built from
    # the rows' lengths drives the kernel's row walk).  Requires
    # ``chunked_prefill`` (the chunk state
    # machine provides admission/growth); non-attention mixers fall back
    # to the per-slot path exactly like chunked prefill does.
    ragged_kernel: bool = False

    def __post_init__(self) -> None:
        if self.num_blocks <= 0 or self.max_batch <= 0:
            raise ValueError(f"num_blocks and max_batch must be positive, "
                             f"got {self.num_blocks} / {self.max_batch}")
        if self.max_seq_len <= 0:
            raise ValueError(f"max_seq_len must be positive, "
                             f"got {self.max_seq_len}")
        # resize_workers revalidates new counts through the same check
        validate_worker_count(self.num_workers)
        if self.islands is not None:
            from repro_torch.core.topology import Topology
            topo = Topology.of(self.islands, num_workers=self.num_workers)
            object.__setattr__(self, "islands",
                               None if topo.is_flat else topo.spec)
        if self.worker_routing not in WORKER_ROUTINGS:
            raise ValueError(f"unknown worker_routing "
                             f"{self.worker_routing!r}; "
                             f"known: {WORKER_ROUTINGS}")
        if not (self.admission is None
                or isinstance(self.admission, (str, GovernorConfig))):
            raise ValueError(
                "admission must be None, a policy name or a GovernorConfig, "
                f"got {type(self.admission).__name__}")
        if self.page_impl not in PAGE_IMPLS:
            raise ValueError(f"unknown page_impl {self.page_impl!r}; "
                             f"known: {PAGE_IMPLS}")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 block, "
                             f"got {self.prefill_chunk}")
        if self.ragged_kernel and not self.chunked_prefill:
            raise ValueError("ragged_kernel requires chunked_prefill "
                             "(the chunk state machine drives admission "
                             "and reservation growth)")

    def governor_config(self) -> Optional[GovernorConfig]:
        """The resolved admission config (None ⇒ governor disabled)."""
        if self.admission is None:
            return None
        if isinstance(self.admission, GovernorConfig):
            return self.admission
        return GovernorConfig(policy=self.admission)


__all__ = ["EngineConfig", "WORKER_ROUTINGS", "PAGE_IMPLS"]
