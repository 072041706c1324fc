"""The Terra executor package: runtime split along its natural seams.

    coordinator.py   — TerraEngine, the phase-machine coordinator
    graph_runner.py  — GraphRunner, the ordered async executor thread
    walker.py        — Walker, TraceGraph validation / Case Select & Loop Cond
    dispatch.py      — Dispatcher protocol; segment + path-chain dispatchers
    fallback.py      — divergence cancellation + validated-prefix replay
    variables.py     — VariableStore, the device-resident variable buffers
    segment_cache.py — cross-version/cross-family compiled-segment cache
    families.py      — shape-keyed TraceGraph families + LRU (DESIGN.md §8)

See DESIGN.md §3 for the layering contract.
"""

from repro_torch.core.executor.coordinator import (IMPERATIVE, SKELETON, TRACING,
                                             TerraEngine)
from repro_torch.core.executor.dispatch import (ChainDispatcher, Dispatcher,
                                          SegmentDispatcher)
from repro_torch.core.executor.fallback import DivergenceHandler
from repro_torch.core.executor.families import (FamilyManager, TraceFamily,
                                          bucket_pow2, feed_signature)
from repro_torch.core.executor.graph_runner import GraphRunner
from repro_torch.core.executor.segment_cache import SegmentCache, segment_signature
from repro_torch.core.executor.variables import VariableStore
from repro_torch.core.executor.walker import (DivergenceError, ReplayRequired,
                                        Walker)

__all__ = [
    "TerraEngine", "GraphRunner", "Walker", "VariableStore",
    "Dispatcher", "SegmentDispatcher", "ChainDispatcher",
    "DivergenceHandler", "SegmentCache", "segment_signature",
    "FamilyManager", "TraceFamily", "bucket_pow2", "feed_signature",
    "DivergenceError", "ReplayRequired",
    "IMPERATIVE", "TRACING", "SKELETON",
]
