"""FPR core — the paper's fast-page-recycling mechanism for paged KV caches.

Public API:

    FprMemoryManager   — allocator + tracking + fences + tables facade
    FenceEngine        — coherence-fence (TLB-shootdown analogue) engine
    WatermarkEvictor   — kswapd analogue with FPR batch eviction
    RecyclingContext / ContextScope / ContextRegistry — §IV-C2 contexts
"""

from repro_torch.core.allocator import BlockAllocator, BuddyAllocator, OutOfBlocksError
from repro_torch.core.block_table import (BlockTableStore, Mapping,
                                    MonotonicIdAllocator, StaleMappingError)
from repro_torch.core.contexts import (ContextRegistry, ContextScope,
                                 RecyclingContext, derive_context)
from repro_torch.core.eviction import KSWAPD_BATCH, WatermarkEvictor, Watermarks
from repro_torch.core.fpr import NOT_RESIDENT, SWAPPED, FprMemoryManager
from repro_torch.core.shootdown import FenceCostModel, FenceEngine, FenceStats
from repro_torch.core.tracking import FLAG_ALWAYS_FLUSH, MAX_CONTEXT_ID, BlockTracker

__all__ = [
    "BlockAllocator", "BuddyAllocator", "OutOfBlocksError",
    "BlockTableStore", "Mapping", "MonotonicIdAllocator", "StaleMappingError",
    "ContextRegistry", "ContextScope", "RecyclingContext", "derive_context",
    "KSWAPD_BATCH", "WatermarkEvictor", "Watermarks",
    "NOT_RESIDENT", "SWAPPED", "FprMemoryManager",
    "FenceCostModel", "FenceEngine", "FenceStats",
    "FLAG_ALWAYS_FLUSH", "MAX_CONTEXT_ID", "BlockTracker",
]
