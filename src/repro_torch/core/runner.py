"""Compatibility shim — the Terra runtime lives in ``core/executor/``.

The reference keeps this module so that the historical import path of its
runner god-module (engine + walker + dispatch + fallback + variable store
in one file) keeps working; the port keeps the same names:

    from repro_torch.core.runner import TerraEngine, GraphRunner, Walker, ...
"""

from repro_torch.core.executor import (  # noqa: F401
    IMPERATIVE,
    SKELETON,
    TRACING,
    ChainDispatcher,
    Dispatcher,
    DivergenceError,
    DivergenceHandler,
    GraphRunner,
    ReplayRequired,
    SegmentCache,
    SegmentDispatcher,
    TerraEngine,
    VariableStore,
    Walker,
)

__all__ = [
    "TerraEngine", "GraphRunner", "Walker", "VariableStore",
    "Dispatcher", "SegmentDispatcher", "ChainDispatcher",
    "DivergenceHandler", "SegmentCache", "DivergenceError",
    "ReplayRequired", "IMPERATIVE", "TRACING", "SKELETON",
]
