"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP).

Model code annotates arrays with *logical* axis names; this module maps them
to mesh axes via a rule table, MaxText-style.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, ``data`` and ``model`` (and ``pod`` where present)
(``launch/mesh.py``); the production meshes are

    single-pod:  (16, 16)            axes ("data", "model")
    multi-pod:   (2, 16, 16)         axes ("pod", "data", "model")

Default rules:
    batch       -> ("pod", "data")      # DP across pods and data axis
    fsdp        -> ("data",)            # ZeRO-3 weight shard (+pod optional)
    tp          -> ("model",)           # tensor parallel: heads / ffn hidden
    expert      -> ("model",)           # EP: MoE expert dim
    seq         -> ()                   # sequence kept unsharded by default
    sp          -> ("model",)           # sequence parallel for long-context
    vocab       -> ("model",)

Under a mesh the values on the model path are DTensors
(``torch.distributed.tensor``), and :func:`logical` redistributes one to
the placements its logical names resolve to: the counterpart of the
reference's ``with_sharding_constraint``.  Where the reference leaves the
rest to XLA's SPMD partitioner, DTensor propagates placements op by op;
:func:`sharded` opens DTensor's implicit replication around such a region,
so tensors made inside the model (positions, masks) act as replicated.
An op for which DTensor has no correct rule runs on an input that
:func:`logical` has replicated over the dim the op reads across;
``NO_RULE_OPS`` names each one.  On one device (no
mesh) :func:`logical` is the identity.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, Optional, Tuple

from repro_torch.parallel.specs import NamedSharding, mesh_view, placements
from repro_torch.parallel.specs import PartitionSpec as P

_TLS = threading.local()

# ops on the model path that run on an input replicated over the dim they
# read across, because DTensor has no correct rule for them (PERF.md
# lists them): aten.gather over the vocab-sharded logits (lm_loss's label
# logit), whose masked-partial result DTensor cannot reduce
NO_RULE_OPS = ("aten.gather: train_step.lm_loss, the label logit",)


DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "fsdp_pod": ("pod", "data"),
    "tp": ("model",),
    "expert": ("model",),
    "capacity": ("data",),     # MoE per-expert token slots shard over data
    "seq": (),
    "sp": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "d_model": (),
    "d_ff": ("model",),
    "unsharded": (),
}


class ShardingPolicy:
    """Resolves logical axis names to mesh axes for a given mesh (a
    ``DeviceMesh``, or ``None``: one device, nothing to resolve)."""

    def __init__(self, mesh=None, rules: Optional[dict] = None):
        if mesh is not None and getattr(mesh, "mesh_dim_names",
                                        None) is None:
            raise ValueError("ShardingPolicy needs a DeviceMesh with "
                             "mesh_dim_names")
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def spec(self, *logical: Optional[str]) -> P:
        if self.mesh is None:
            return P()
        names = self.mesh.mesh_dim_names
        parts = []
        for name in logical:
            if name is None:
                parts.append(None)
                continue
            axes = tuple(a for a in self.rules.get(name, ()) if a in names)
            parts.append(axes if axes else None)
        return P(*parts)

    def sharding(self, *logical: Optional[str]) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(*logical))


def current_policy() -> Optional[ShardingPolicy]:
    return getattr(_TLS, "policy", None)


def current_mesh():
    pol = current_policy()
    return None if pol is None else pol.mesh


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    prev = current_policy()
    _TLS.policy = policy
    try:
        yield policy
    finally:
        _TLS.policy = prev


@contextlib.contextmanager
def sharded():
    """The model path under the current mesh: DTensor's implicit
    replication (plain tensors act as replicated DTensors); nothing
    without a mesh."""
    if current_mesh() is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def _fixed_spec(pol: ShardingPolicy, shape, names) -> P:
    """The resolved spec, never requesting a partition that does not
    divide the dim, and never one mesh axis for two tensor dims (first
    occurrence wins)."""
    sizes = mesh_view(pol.mesh).shape
    fixed = []
    used: set = set()
    for dim, part in zip(shape, pol.spec(*names)):
        if part is None:
            fixed.append(None)
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        axes = tuple(a for a in axes if a not in used)
        size = 1
        for a in axes:
            size *= sizes[a]
        if not axes or dim % size != 0:
            fixed.append(None)
            continue
        used.update(axes)
        fixed.append(axes if len(axes) > 1 else axes[0])
    return P(*fixed)


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor on the model path
    is the same on every rank, so it is taken as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def logical(x, *names: Optional[str]):
    """Annotate activation sharding with logical axis names: under a mesh
    ``x`` (a DTensor, or a plain tensor taken as replicated) is
    redistributed to the placements the names resolve to.  The identity
    when no policy/mesh is active (one device)."""
    pol = current_policy()
    if pol is None or pol.mesh is None:
        return x
    if len(names) != x.ndim:
        raise ValueError(f"rank mismatch: {names} for shape {x.shape}")
    spec = _fixed_spec(pol, tuple(x.shape), names)
    return as_dtensor(x, pol.mesh).redistribute(
        pol.mesh, placements(pol.mesh, spec))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (never, and nothing imported, while
    DTensor's module is not loaded: the one-device paths)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x, *names: Optional[str]):
    """An activation constraint of the model (the reference's ``logical``
    calls there): ``logical(x, *names)`` for a DTensor under a mesh, else
    ``x`` as it is (a plain tensor stays plain)."""
    if current_mesh() is None or not is_dtensor(x):
        return x
    return logical(x, *names)


def gathered(w):
    """A parameter as a matmul reads it: under a mesh a DTensor's shards
    over the FSDP axes (``fsdp_pod``) are all-gathered first, as ZeRO-3
    (and the reference's partitioner) does; else ``w`` as it is."""
    from torch.distributed.tensor import Replicate, Shard
    if current_mesh() is None or not is_dtensor(w):
        return w
    fsdp = set(current_policy().rules.get("fsdp_pod", ()))
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if isinstance(p, Shard) and n in fsdp else p
          for p, n in zip(w.placements, names)]
    return w.redistribute(w.device_mesh, pl) if pl != list(w.placements) \
        else w


def replicated(x):
    """A DTensor redistributed whole onto every rank; else ``x``."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def param_spec(shape, logical_axes, pol: ShardingPolicy) -> P:
    """PartitionSpec for a parameter, dropping non-divisible partitions."""
    sizes = mesh_view(pol.mesh).shape
    fixed = []
    for dim, part in zip(shape, pol.spec(*logical_axes)):
        if part is None:
            fixed.append(None)
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        size = 1
        for a in axes:
            size *= sizes[a]
        fixed.append(part if dim % size == 0 else None)
    return P(*fixed)
