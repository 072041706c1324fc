"""Engine checkpoint/restore (DESIGN.md §14).

A checkpoint is a plain directory (NOT content-addressed, works without
``$TERRA_CACHE_DIR``): ``variables.npz`` holds every VariableStore buffer
keyed by var id, ``engine.json`` the iteration counter (which keeps the
per-iteration rng stream — a function of (seed, iteration, draw) — aligned
after restore) and the released-variable tombstones.

The on-disk format is the reference's, byte for byte: every array is
flattened to raw bytes beside a ``<k>__meta`` string array of
``[dtype name, *shape]``.  bfloat16 travels as its 16-bit patterns and is
decoded through ``Tensor.view`` (numpy has no bfloat16), so a checkpoint
that either package wrote restores in the other.

Restore is buffer seeding, deliberately decoupled from Variable
registration: ``VariableStore.ensure`` only seeds a buffer when none
exists, so buffers restored *before* the program re-registers its
Variables survive registration and the first iteration reads checkpointed
state.  What is NOT in a checkpoint: TraceGraphs, compiled segments and
walker state (the artifact store covers those; a restored engine without
a warm cache simply retraces — slower, never wrong) and pending runner
work (callers checkpoint at iteration boundaries, after ``sync()``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.events import emit as ev
from repro_torch.core.trace import dtype_name, torch_dtype

FORMAT = 1


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _host_bytes(v):
    """(raw little-endian bytes as uint8, dtype name, shape) of a tensor
    or array; bfloat16 as its bit patterns."""
    if isinstance(v, torch.Tensor):
        t = v.detach().contiguous()
        name = dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.cpu().numpy()
    else:
        a = np.ascontiguousarray(np.asarray(v))
        name = str(a.dtype)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8), name, a.shape


def pack_arrays(arrays: dict) -> dict:
    """Flatten arrays to raw bytes + a string sidecar (``k__meta`` =
    [dtype, *shape]), the reference's layout: bfloat16 survives
    ``np.savez``, which would otherwise need a numpy type for it."""
    out = {}
    for k, v in arrays.items():
        raw, name, shape = _host_bytes(v)
        out[k] = raw
        out[f"{k}__meta"] = np.array([name] + [str(s) for s in shape])
    return out


def _meta(z, k: str):
    meta = [str(x) for x in z[f"{k}__meta"]]
    return meta[0], tuple(int(s) for s in meta[1:])


def unpack_tensor(z, k: str) -> torch.Tensor:
    """A packed array as a CPU tensor of its recorded dtype."""
    name, shape = _meta(z, k)
    raw = z[k]
    if name == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(name)).copy())
        if t.dtype != torch_dtype(name):
            raise ValueError(f"{k}: dtype {name} has no torch counterpart")
    return t.reshape(shape)


def unpack_array(z, k: str) -> np.ndarray:
    """A packed array as numpy (any dtype numpy has; not bfloat16)."""
    name, shape = _meta(z, k)
    return z[k].view(np.dtype(name)).reshape(shape)


def save_engine(engine, path: str) -> None:
    """Snapshot VariableStore buffers + iteration state into ``path``."""
    engine.sync()
    os.makedirs(path, exist_ok=True)
    arrays = {str(vid): buf for vid, buf in engine.store.buffers.items()}
    npz = os.path.join(path, "variables.npz")
    tmp = os.path.join(path, f"variables.tmp{os.getpid()}.npz")
    np.savez(tmp, **pack_arrays(arrays))
    os.replace(tmp, npz)
    meta = {"fmt": FORMAT, "iter_id": engine.iter_id,
            "tombstones": [[int(vid), [list(s), dtype_name(dt)]]
                           for vid, (s, dt)
                           in sorted(engine.store.tombstones.items())]}
    _write_atomic(os.path.join(path, "engine.json"),
                  json.dumps(meta, indent=1).encode("utf-8"))
    engine.stats["checkpoint_saves"] += 1
    ev.checkpoint_save(engine.events, path, vars_saved=len(arrays))


def restore_engine(engine, path: str) -> dict:
    """Seed a fresh engine from a checkpoint directory; call before the
    first iteration (buffers must land before Variables re-register).
    Raises on a missing or malformed checkpoint — a checkpoint is
    explicit state the caller asked for, so unlike the artifact store a
    failure here must not silently degrade to a cold start."""
    with open(os.path.join(path, "engine.json"), "rb") as f:
        meta = json.loads(f.read().decode("utf-8"))
    if meta.get("fmt") != FORMAT:
        raise ValueError(f"unsupported checkpoint format {meta.get('fmt')!r}")
    with np.load(os.path.join(path, "variables.npz")) as z:
        for k in z.files:
            if k.endswith("__meta"):
                continue
            engine.store.buffers[int(k)] = unpack_tensor(z, k).to(
                engine.device)
    engine.iter_id = int(meta["iter_id"])
    for vid, (shape, dt) in meta["tombstones"]:
        if int(vid) not in engine.store.vars:
            engine.store.tombstones.setdefault(
                int(vid), (tuple(shape), torch_dtype(dt)))
    engine.stats["checkpoint_restores"] += 1
    ev.checkpoint_restore(engine.events, path,
                          vars_restored=len(engine.store.buffers))
    return meta
