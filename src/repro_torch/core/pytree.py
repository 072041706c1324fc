"""Minimal pytree helper: nested tuples, lists and dicts of leaves.

The engine threads parameters and caches leaf by leaf, so the port needs
the same flatten order the reference gets from ``jax.tree_util``: dict
keys in **sorted** order, tuples and lists in position order, ``None`` as
an empty subtree (no leaf).  Everything else — tensors, numpy arrays,
scalars, TerraTensors — is a leaf.  Treedefs are plain nested tuples, so
they hash and compare by value (the steady-state planner compares them).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = ("*",)
_NONE = ("none",)


def _flatten(t, leaves: List[Any]) -> Tuple:
    if t is None:
        return _NONE
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_flatten(t[k], leaves) for k in keys))
    if isinstance(t, (tuple, list)):
        return (type(t).__name__, len(t),
                tuple(_flatten(x, leaves) for x in t))
    leaves.append(t)
    return _LEAF


def tree_flatten(tree) -> Tuple[List[Any], Tuple]:
    """-> (leaves, treedef).  (Module-level recursion: a recursive closure
    is a reference cycle that would keep the leaves alive until the
    cyclic collector runs.)"""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _unflatten(d: Tuple, it) -> Any:
    kind = d[0]
    if kind == "*":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(d[1], d[2])}
    kids = [_unflatten(c, it) for c in d[2]]
    return tuple(kids) if kind == "tuple" else kids


def tree_unflatten(treedef: Tuple, leaves) -> Any:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        ls, td = tree_flatten(r)
        if td != treedef:
            raise ValueError("tree_map over trees of different structure")
        others.append(ls)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
