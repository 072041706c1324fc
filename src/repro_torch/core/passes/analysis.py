"""Shared analyses for the optimization passes (DESIGN.md §10).

Two kinds of input feed the pipeline:

* **Structural** — liveness over the (cloned) TraceGraph and region/order
  maps over its Structure, computed fresh per pipeline run.
* **Observational** — per-family records accumulated across *traced*
  iterations, because two legality questions are invisible to the graph:
  did an Input Feeding slot ever change value (constant-feed folding), and
  how late does Python actually read each fetched value (segment
  coalescing)?  Both records only move in the conservative direction:
  a slot marked varying never becomes stable again, and a fetch's earliest
  observed read point only ever moves earlier.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np

import torch

from repro_torch.core.trace import Ref, SyncMarker, TraceEntry, to_numpy

Key = Tuple[int, int]

# feeds larger than this (bytes) are never considered for folding: the
# equality probe runs on the Python thread every traced iteration and the
# folded value is baked into the segment as a constant
MAX_FOLD_BYTES = 1 << 16


def _host(value) -> np.ndarray:
    """Host copy of a feed value for the fold probes; bfloat16 has no
    numpy type, so such a feed never folds (the probe raises)."""
    if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
        raise TypeError("bfloat16 feeds are not folded")
    return to_numpy(value)


class FoldedConst:
    """A hashable baked constant standing in a rewritten ``srcs`` slot.

    Segment signatures are dict keys, so the folded value is identified by
    a digest of its bytes; ``_resolve`` unwraps ``.value`` at compile time.
    """

    __slots__ = ("value", "_key")

    def __init__(self, value):
        self.value = _host(value)
        v = self.value
        self._key = (v.shape, str(v.dtype), hash(v.tobytes()))

    def equals(self, other) -> bool:
        try:
            o = _host(other)
        except TypeError:
            return False
        return (o.shape == self.value.shape
                and o.dtype == self.value.dtype
                and np.array_equal(o, self.value))

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, FoldedConst) and self._key == other._key

    def __repr__(self):
        return f"FoldedConst(shape={self.value.shape})"


_VARYING = object()


class FeedObservations:
    """Per-family Input Feeding stability record: (uid, arg_pos) -> either
    (value, count) while every observed value matched, or varying forever
    after the first mismatch.  ``version`` bumps exactly when a pipeline
    rerun could change its output (a slot becoming foldable at its second
    stable observation, or a fold candidate going varying)."""

    def __init__(self):
        self.slots: Dict[Key, Any] = {}
        self.version = 0

    def observe(self, key: Key, value) -> None:
        cur = self.slots.get(key)
        if cur is _VARYING:
            return
        try:
            arr = _host(value)
        except Exception:
            self.slots[key] = _VARYING
            return
        if arr.nbytes > MAX_FOLD_BYTES or arr.dtype == object:
            self.slots[key] = _VARYING
            return
        if cur is None:
            self.slots[key] = (arr, 1)
            return
        prev, count = cur
        if prev.shape == arr.shape and prev.dtype == arr.dtype \
                and np.array_equal(prev, arr):
            self.slots[key] = (prev, count + 1)
            if count + 1 == 2:      # now foldable
                self.version += 1
        else:
            self.slots[key] = _VARYING
            if count >= 2:          # was foldable
                self.version += 1

    def stable_value(self, key: Key):
        """The fold candidate for ``key``: its value if every observation
        matched at least twice, else None."""
        cur = self.slots.get(key)
        if cur is None or cur is _VARYING:
            return None
        value, count = cur
        return value if count >= 2 else None


class FetchObservations:
    """Per-family Output Fetching timing record: for each fetched
    (uid, out_idx), the set of 'last validated node uids' at the moments
    Python materialized it mid-iteration.  Coalescing asks: was this value
    *ever* read before the end of the following segment?  An unobserved
    key imposes no constraint (it was only read after the iteration
    closed, which is the note_fetch non-gating path)."""

    MAX_POINTS = 8

    def __init__(self):
        self.read_after: Dict[Key, Set[Optional[int]]] = {}
        self.version = 0

    def observe(self, key: Key, last_uid: Optional[int]) -> None:
        pts = self.read_after.get(key)
        if pts is None:
            pts = self.read_after[key] = set()
        if last_uid in pts:
            return
        if len(pts) >= self.MAX_POINTS:
            # too many distinct read points: pin the most conservative
            last_uid = None         # "read immediately" sentinel
            if last_uid in pts:
                return
        pts.add(last_uid)
        self.version += 1

    def earliest_read_pos(self, key: Key, flatpos: Dict[int, int]):
        """Smallest flat program position at which ``key`` was observed
        read, or None when it was never read mid-iteration."""
        pts = self.read_after.get(key)
        if not pts:
            return None
        return min(flatpos.get(u, -1) if u is not None else -1
                   for u in pts)


def observe_iteration(trace, feed_log: Dict, tg, feed_obs: FeedObservations,
                      fetch_obs: FetchObservations) -> None:
    """Record one traced iteration into the family's observation state.
    Must run after ``merge_trace`` (uses ``tg.last_ord_to_uid``)."""
    ord_to_uid = getattr(tg, "last_ord_to_uid", None)
    if ord_to_uid is None:
        return
    last_uid: Optional[int] = None
    for ev in trace.events:
        if isinstance(ev, TraceEntry):
            u = ord_to_uid.get(getattr(ev, "_ordinal", -1))
            if u is not None:
                last_uid = u
        elif isinstance(ev, SyncMarker) and isinstance(ev.ref, Ref):
            uid = ord_to_uid.get(ev.ref.entry)
            if uid is None:
                continue
            n = tg.nodes[uid]
            if n.kind == "loop":
                oi = n.body.out_slot_for(ev.ref,
                                         getattr(n, "_last_ordinals", ()))
            else:
                oi = ev.ref.out_idx
            fetch_obs.observe((uid, oi), last_uid)
    for (ordinal, pos), value in feed_log.items():
        uid = ord_to_uid.get(ordinal)
        if uid is None or tg.nodes[uid].kind == "loop":
            continue
        feed_obs.observe((uid, pos), value)


# --------------------------------------------------------------------------
# Structural analyses
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RegionInfo:
    """Flat execution order + enclosing-region path per node uid.

    ``flatpos`` is a depth-first program position (branch interiors before
    the post-join continuation); ``path[uid]`` is the chain of
    (fork_uid, branch_idx) regions enclosing the node.  A node R executes
    on every path through node N iff path(R) is a prefix of path(N) and
    flatpos(R) < flatpos(N) — the CSE dominance test."""
    flatpos: Dict[int, int]
    path: Dict[int, Tuple[Tuple[int, int], ...]]


def region_info(structure) -> RegionInfo:
    from repro_torch.core.casing import NodeItem, SwitchItem
    flatpos: Dict[int, int] = {}
    path: Dict[int, Tuple] = {}
    counter = [0]

    def walk(program, cur_path):
        for item in program:
            if isinstance(item, NodeItem):
                flatpos[item.uid] = counter[0]
                path[item.uid] = cur_path
                counter[0] += 1
            elif isinstance(item, SwitchItem):
                flatpos[item.fork_uid] = counter[0]
                path[item.fork_uid] = cur_path
                counter[0] += 1
                for bi, b in enumerate(item.branches):
                    walk(b, cur_path + ((item.fork_uid, bi),))
    walk(structure.program, ())
    return RegionInfo(flatpos, path)


def live_uids(otg, opt) -> Set[int]:
    """Transitive liveness over the optimized graph: roots are nodes with
    fetch annotations, variable assignments or loop variable bindings;
    liveness propagates through effective sources (alias keys for CSE'd
    nodes).  Nodes already marked dead contribute nothing."""
    roots = []
    for uid, n in otg.nodes.items():
        if n.kind not in ("op", "loop") or uid in opt.dead:
            continue
        if n.fetch_idxs or n.var_assigns or (
                n.kind == "loop" and n.body is not None and n.body.var_binds):
            roots.append(uid)
    live: Set[int] = set()
    stack = list(roots)
    while stack:
        uid = stack.pop()
        if uid in live:
            continue
        live.add(uid)
        for s in opt.eff_srcs(otg.nodes[uid]):
            if s[0] == "node" and s[1] not in live:
                stack.append(s[1])
    return live
