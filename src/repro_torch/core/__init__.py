"""Terra: imperative-symbolic co-execution (the paper's contribution).

Public surface:
    terra.function / TerraFunction — manage an imperative program
    terra.imperative               — pure-imperative baseline engine
    ops.*                          — the instrumented DL op namespace
    GradientTape                   — tape autodiff (backward ops are traced)
    Variable                       — mutable state threaded through graphs
    terra_op                       — register a pure torch fn as one DL op
"""

from repro_torch.core import ops
from repro_torch.core.engine import TerraFunction, function, imperative
from repro_torch.core.ops import GradientTape, terra_op
from repro_torch.core.executor import (SKELETON, TRACING, DivergenceError,
                                       TerraEngine)
from repro_torch.core.tensor import TerraTensor, Variable

__all__ = [
    "ops", "TerraFunction", "function", "imperative", "GradientTape",
    "terra_op", "Variable", "TerraTensor", "TerraEngine",
    "DivergenceError", "SKELETON", "TRACING",
]
