"""Gradient compression for the data-parallel all-reduce.

Two schemes, both with error feedback so compression noise does not bias
the optimizer:

* ``bf16``  — cast f32 grads to bf16 before the all-reduce (halves the
  gradient wire bytes; the residual r = g - decompress(compress(g)) is
  carried to the next step).
* ``int8``  — block scale quantization (4x reduction); blocks of 256
  values share one f32 scale.  The codec and its wire bytes are here, as
  in the reference; the all-reduce takes "none" and "bf16" only.

``dp_allreduce(mesh, axis, compression=)`` is the explicit data-parallel
gradient mean over the process group of one mesh axis, where the
collective is visible (the reference's shard_map step).  Each rank passes
its own gradients and residuals (plain tensors) and gets back the mean
and its new residuals.  Any other compression raises ``ValueError``, as
the reference's does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------

def compress_bf16(g):
    return g.to(torch.bfloat16)


def decompress_bf16(c):
    return c.to(torch.float32)


def compress_int8(g, block: int = 256):
    flat = g.reshape(-1)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32), tuple(g.shape), pad


def decompress_int8(packed):
    q, scale, shape, pad = packed
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


# --------------------------------------------------------------------------
# error-feedback compressed all-reduce
# --------------------------------------------------------------------------

def _mean_none(g, r, group, n):
    import torch.distributed as dist
    out = g.to(torch.float32).clone()
    dist.all_reduce(out, group=group)
    return out / n, r


def _mean_bf16(g, r, group, n):
    import torch.distributed as dist
    g = g.to(torch.float32) + r
    c = compress_bf16(g)
    new_r = g - decompress_bf16(c)
    dist.all_reduce(c, group=group)              # bf16 on the wire
    return decompress_bf16(c) / n, new_r


_REDUCE = {"none": _mean_none, "bf16": _mean_bf16}


def compressed_mean(grads, residuals, group, compression: str = "bf16"):
    """(mean of ``grads`` over ``group``, new residuals), leaf by leaf."""
    import torch.distributed as dist
    one = _REDUCE[compression]
    n = dist.get_world_size(group)
    flat_g, treedef = tree_flatten(grads)
    out = [one(g, r, group, n)
           for g, r in zip(flat_g, tree_leaves(residuals))]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            tree_unflatten(treedef, [o[1] for o in out]))


def zero_residuals(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def dp_allreduce(mesh, axis: str, compression: str = "bf16"):
    """Explicit data-parallel gradient mean over ``mesh``'s ``axis`` (a
    ``DeviceMesh``) with optional compression: returns
    ``apply(grads, residuals) -> (mean, new residuals)``."""
    if compression not in _REDUCE:
        raise ValueError(compression)
    group = mesh.get_group(axis)

    def apply(grads, residuals):
        return compressed_mean(grads, residuals, group, compression)

    return apply


def wire_bytes_saved(grads, compression: str) -> Tuple[int, int]:
    """(uncompressed, compressed) wire bytes for reporting."""
    total = sum(g.numel() * 4 for g in tree_leaves(grads))
    factor = {"none": 1.0, "bf16": 0.5, "int8": 0.25 + 4.0 / 256}[compression]
    return total, int(total * factor)
