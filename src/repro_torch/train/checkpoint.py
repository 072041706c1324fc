"""Atomic, async checkpointing in the reference's on-disk format.

Layout:
    <dir>/step_<N>/manifest.json       step, keys, shapes, dtypes
    <dir>/step_<N>/arrays.npz          flattened pytree (path -> array)
    <dir>/latest                       text file naming the committed step

Keys are the tree paths joined by ``|`` (dict keys, list indices), as the
reference names them; bfloat16 leaves are stored bit for bit as
``uint16`` with their true dtype in the manifest.  So a checkpoint written
by either package restores in the other.  (numpy has no bfloat16: the bits
move through ``Tensor.view(torch.int16)``.)

Commit protocol: write into ``step_<N>.tmp`` then ``os.rename`` (atomic on
POSIX) and update ``latest`` — a crash mid-save never corrupts the previous
checkpoint (fault-tolerance requirement).

Restore places every leaf on its template leaf's device and dtype.
Elastic restore: ``restore(..., shardings=...)`` places every leaf with
``distribute_tensor`` on the *current* mesh and placements
(``parallel.specs.NamedSharding``), so a run checkpointed by one process
resumes on several and back (reshard-on-load).  Under a mesh the caller
gathers the full tree (``DTensor.full_tensor``) and one rank writes."""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.pytree import tree_flatten, tree_unflatten
from repro_torch.core.trace import dtype_name

SEP = "|"
_COMMIT_LOCK = threading.Lock()   # serializes the atomic swap


def _flatten(tree) -> Dict[str, Any]:
    """Path-keyed leaves, in the pytree's flatten order."""
    flat: Dict[str, Any] = {}

    def go(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                go(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                go(x, path + (str(i),))
        else:
            flat[SEP.join(path)] = t

    go(tree, ())
    return flat


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True):
    """Checkpoint ``tree`` (of tensors) at ``step``.  With blocking=False
    the disk write happens on a background thread (async checkpointing)
    after the host copy has been snapshotted."""
    flat = _flatten(tree)
    true_dtypes = {k: dtype_name(v.dtype) for k, v in flat.items()}
    host = {k: _to_host(v) for k, v in flat.items()}   # device->host snapshot

    def commit():
        # unique tmp dir: concurrent async+blocking saves of the same step
        # must not collide (the rename is still the atomic commit point)
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp.{os.getpid()}."
                                     f"{threading.get_ident()}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "keys": sorted(host.keys()),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": true_dtypes,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with _COMMIT_LOCK:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            lat = os.path.join(ckpt_dir, f"latest.tmp.{threading.get_ident()}")
            with open(lat, "w") as f:
                f.write(str(step))
            os.replace(lat, os.path.join(ckpt_dir, "latest"))

    os.makedirs(ckpt_dir, exist_ok=True)
    if blocking:
        commit()
        return None
    t = threading.Thread(target=commit, daemon=True, name="ckpt-save")
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _leaf(arr: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def restore(ckpt_dir: str, step: int, template, *, shardings=None):
    """Restore into the structure of ``template`` (each leaf on its
    template leaf's device, in its dtype).  ``shardings``: optional
    matching pytree of ``NamedSharding`` (or a single one) — each leaf
    then becomes a DTensor placed by its sharding (reshard-on-load)."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(final, "arrays.npz")) as z:
        host = {k: z[k] for k in z.files}
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    keyed = _flatten(template)
    missing = [k for k in keyed if k not in host]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    _, treedef = tree_flatten(template)
    new_leaves = [_leaf(host[k], manifest["dtypes"][k], tmpl)
                  for k, tmpl in keyed.items()]
    if shardings is not None:
        from repro_torch.parallel.specs import NamedSharding, distribute
        shard_flat = ([shardings] * len(new_leaves)
                      if isinstance(shardings, NamedSharding)
                      else [_flatten(shardings).get(k) for k in keyed])
        if not all(isinstance(s, NamedSharding) for s in shard_flat):
            raise TypeError("shardings: a NamedSharding or a tree of them "
                            "matching the template")
        new_leaves = [distribute(t, sh)
                      for t, sh in zip(new_leaves, shard_flat)]
    return tree_unflatten(treedef, new_leaves)
