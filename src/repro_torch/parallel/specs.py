"""Parameter / batch / cache PartitionSpecs for the production meshes.

Name-pattern rules (Megatron/MaxText-style), the reference's own:
  column-parallel weights  [d, X]      -> (fsdp, tp)       X = heads*hd | d_ff
  row-parallel weights     [X, d]      -> (tp, fsdp)
  MoE expert weights       [E, d, f]   -> (expert=tp, -, -)   (fine-grained)
                                          fallback (-, fsdp, tp) when E does
                                          not divide the model axis (Mixtral)
  embeddings / lm head     [V, d]      -> (tp=vocab, fsdp)
  vectors / scalars                    -> replicated
Stacked super-block leaves get a leading None.  Every rule drops
non-divisible partitions.

KV caches shard batch over (pod, data) and the *sequence* dim over the
model axis (sequence parallelism): kv-head counts (8) do not divide a
16-way model axis.

A spec is a :class:`PartitionSpec`: one entry per tensor dim, each a mesh
axis name, a tuple of names or ``None``.  Specs are computed from any
mesh-like object with ``.shape`` (axis -> size) and ``.axis_names`` — a
``torch.distributed`` ``DeviceMesh`` (through :func:`mesh_view`) or the
abstract meshes of ``launch/mesh.py`` — so no process group is needed to
compute one.  :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``; a :class:`NamedSharding` is a spec on a mesh, and
:func:`distribute` places a tensor by one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

COLUMN = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_in_x", "w_in_y",
          "w_a", "w_x", "w_router"}
ROW = {"wo", "w_down", "w_out"}
EMBED = {"embed", "lm_head", "enc_pos"}
SEP = "|"


class PartitionSpec:
    """Per-dim mesh axes of one tensor: ``P("model", None)``.  It reads
    as the tuple of its entries but is a pytree leaf (not a tuple), so a
    tree of specs has the structure of its tree of tensors.  A one-axis
    tuple is stored as the axis name, as ``jax.sharding.PartitionSpec``
    stores it."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1
                           else p for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            other = other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}".replace(",)", ")")


P = PartitionSpec


class MeshView:
    """``.shape`` (axis -> size) and ``.axis_names`` of a mesh: the view the
    spec rules read.  Also the abstract mesh of ``launch/mesh.py``."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def __repr__(self):
        return f"MeshView({self.shape})"


def mesh_view(mesh):
    """A ``DeviceMesh`` as a :class:`MeshView`; anything that already has
    ``.shape`` as a mapping passes through."""
    if mesh is None or isinstance(getattr(mesh, "shape", None), dict):
        return mesh
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the DeviceMesh needs mesh_dim_names")
    return MeshView(dict(zip(names, mesh.mesh.shape)))


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fit(mesh, dim: int, axes) -> Optional[Any]:
    """Return axes if they divide dim, else None (replicate)."""
    if not axes:
        return None
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return None
    if dim % _axes_size(mesh, axes):
        return None
    return axes if len(axes) > 1 else axes[0]


def param_spec_for(mesh, path: str, shape: Tuple[int, ...],
                   fsdp: bool = True) -> P:
    """PartitionSpec for one parameter leaf, identified by its tree path.

    ``fsdp=False`` (serve mode): parameters shard over the model axis
    only."""
    mesh = mesh_view(mesh)
    name = path.split(SEP)[-1]
    data_axes = ("data",) if fsdp else ()
    nd = len(shape)
    lead = ()                       # stacked super-block axis
    core = tuple(shape)
    if name in COLUMN | ROW and nd in (3, 4):   # 4: stacked MoE experts
        lead, core = (None,), core[1:]

    if name in EMBED and nd == 2:
        return P(_fit(mesh, shape[0], ("model",)),
                 _fit(mesh, shape[1], data_axes))
    if len(core) == 3 and name in COLUMN | ROW:
        # expert weights [E, d, f] / [E, f, d]
        e = _fit(mesh, core[0], ("model",))
        if e is not None:
            return P(*lead, e, None, None)
        if name in ROW:
            return P(*lead, None, _fit(mesh, core[1], ("model",)),
                     _fit(mesh, core[2], data_axes))
        return P(*lead, None, _fit(mesh, core[1], data_axes),
                 _fit(mesh, core[2], ("model",)))
    if len(core) == 2 and name in COLUMN:
        return P(*lead, _fit(mesh, core[0], data_axes),
                 _fit(mesh, core[1], ("model",)))
    if len(core) == 2 and name in ROW:
        return P(*lead, _fit(mesh, core[0], ("model",)),
                 _fit(mesh, core[1], data_axes))
    # conv kernels, norm scales, biases, gates, router scalars: replicate
    return P(*([None] * nd))


def flat_paths(tree, path=()):
    """(``|``-joined path, leaf) in the pytree's flatten order: dict keys
    sorted, list and tuple entries by index (the reference's key names)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from flat_paths(x, path + (str(i),))
    else:
        yield SEP.join(path), tree


def _rebuild(tree, leaves):
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    return tree_unflatten(tree_flatten(tree)[1], leaves)


def tree_param_specs(mesh, params, fsdp: bool = True):
    return _rebuild(params, [param_spec_for(mesh, k, tuple(leaf.shape),
                                            fsdp=fsdp)
                             for k, leaf in flat_paths(params)])


def opt_state_specs(mesh, opt_state, param_specs):
    """m / v / master mirror the parameter sharding; step is replicated."""
    return {
        "step": P(),
        "m": param_specs, "v": param_specs, "master": param_specs,
    }


def batch_axes(mesh):
    mesh = mesh_view(mesh)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh, shape: Tuple[int, ...]) -> P:
    b = _fit(mesh_view(mesh), shape[0], batch_axes(mesh))
    return P(b, *([None] * (len(shape) - 1)))


def cache_spec_for(mesh, path: str, shape: Tuple[int, ...]) -> P:
    """KV/recurrent cache leaves.  k/v: [nb, B, S, Hkv, D] -> batch over
    (pod,data), seq over model (SP).  Recurrent states: batch only."""
    mesh = mesh_view(mesh)
    name = path.split(SEP)[-1]
    if name in ("k", "v") and len(shape) >= 5:
        return P(None, _fit(mesh, shape[1], batch_axes(mesh)),
                 _fit(mesh, shape[2], ("model",)), None, None)
    if name in ("k", "v") and len(shape) == 4:     # unstacked (extra blocks)
        return P(_fit(mesh, shape[0], batch_axes(mesh)),
                 _fit(mesh, shape[1], ("model",)), None, None)
    if name == "len":
        return P()
    # conv/ssm/h states: shard batch; distribute width over model if it fits
    if len(shape) >= 2:
        bdim = 1 if len(shape) >= 3 else 0
        spec = [None] * len(shape)
        spec[bdim] = _fit(mesh, shape[bdim], batch_axes(mesh))
        spec[-1] = _fit(mesh, shape[-1], ("model",))
        return P(*spec)
    return P(*([None] * len(shape)))


def tree_cache_specs(mesh, cache):
    return _rebuild(cache, [cache_spec_for(mesh, k, tuple(leaf.shape))
                            for k, leaf in flat_paths(cache)])


def placements(mesh, spec):
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one
    per mesh dim, ``Shard(i)`` where tensor dim i names that mesh axis,
    else ``Replicate()``.  A tensor dim over several axes shards over
    them in mesh order, as a tuple of axes does in the reference."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                   for a in axes):
            raise ValueError(f"{spec}: axes {axes} out of mesh order "
                             f"{names}")
        for a in axes:
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"{spec}: axis {a!r} used twice")
            out[names.index(a)] = Shard(dim)
    return tuple(out)


class NamedSharding:
    """A spec on a ``DeviceMesh``: where one tensor lives (the reference's
    ``NamedSharding``).  A pytree leaf."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self):
        return placements(self.mesh, self.spec)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"


def distribute(t, sharding: NamedSharding):
    """``t`` (the same full tensor on every rank) as a DTensor placed by
    ``sharding``: each rank keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def tree_shardings(mesh, params, fsdp: bool = True):
    return _rebuild(params, [NamedSharding(mesh, param_spec_for(
        mesh, k, tuple(leaf.shape), fsdp=fsdp))
        for k, leaf in flat_paths(params)])


def opt_state_shardings(mesh, param_shardings):
    """m / v / master mirror the parameter shardings; step is replicated."""
    return {"step": NamedSharding(mesh, P()), "m": param_shardings,
            "v": param_shardings, "master": param_shardings}
