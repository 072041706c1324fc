"""Parameters made by the reference, converted for the port.

``params_from_jax`` takes the reference's ``init_params`` pytree with its
leaves already converted to numpy (``jax.tree.map(np.asarray, params)``)
and returns the port's params with the same nesting and, flattened, the
same leaf order.  bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which torch cannot read: they pass through float32 (exact) and are cast
back.  This module imports neither JAX nor the reference.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(a, device, dtype):
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    # a fresh, writable copy (numpy views of JAX arrays are read-only)
    t = torch.from_numpy(np.array(a, dtype=np.float32 if bf16 else a.dtype))
    if bf16:
        t = t.to(torch.bfloat16)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Any, device, dtype=None) -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same nesting of
    tensors on ``device`` (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)
