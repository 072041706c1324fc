"""Cross-version compiled-segment cache.

Every TraceGraph version bump used to recompile *every* segment: a
divergence that adds one branch forced ``GraphProgram.__init__`` to build
fresh callables for all segments.  Most bumps are local — the paper's programs
diverge on one branch or one new fetch — so the unchanged segments' callables are perfectly reusable.

``segment_signature`` captures everything a compiled segment's behaviour
depends on:

* the structured item list (nodes, switch regions with their phi specs,
  loop bodies with unroll/dynamic trip handling),
* per-node state read at trace time (op, attrs, srcs, out avals, fetch
  annotations, variable assignments),
* the segment's IO contract (variable read/write/donation split, carries,
  feed and fetch slot layouts),
* the global Case Select / Loop Cond slot indices the segment indexes into.

Two segments with equal signatures run the same computation with the same
calling convention, so the cached callable — which closes over the
*shared, in-place-merged* TraceGraph nodes of an older GraphProgram — is
exchangeable.  Node uids are stable across merges (merge_trace mutates the
graph in place and only ever appends nodes), which is what makes signature
equality across versions common in practice.

The cache is engine-lifetime; after every regeneration the coordinator
calls :meth:`SegmentCache.retain` with the new program's signatures, which
evicts stale entries (each cached fn closes over its originating
GraphProgram, so unbounded retention would pin old programs) while keeping
every reusable callable (DESIGN.md §4.1).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from repro_torch.core.casing import NodeItem, SwitchItem


def _remap_srcs(srcs, R) -> Tuple:
    return tuple(("node", R(s[1]), s[2]) if s[0] == "node" else s
                 for s in srcs)


def _node_sig(gp, uid: int, R) -> Tuple:
    # signatures are computed over the POST-pass graph (gp.otg): rewritten
    # sources, folded constants and cleared gating flags are all part of
    # the compiled function's identity, and dead/alias execution state is
    # appended explicitly (a skipped node lowers to nothing; an alias
    # node lowers to rebinding its representative's outputs)
    n = gp.otg.nodes[uid]
    if uid in gp._dead:
        return (R(uid), "dead")
    alias = gp._alias.get(uid)
    if alias is not None:
        return (R(uid), "alias", tuple((R(u), oi) for u, oi in alias),
                n.out_avals, tuple(sorted(n.fetch_idxs)),
                tuple(n.var_assigns))
    base = (R(uid), n.kind, n.op_name, n.attrs, n.location,
            _remap_srcs(n.srcs, R), n.out_avals,
            tuple(sorted(n.fetch_idxs)),
            tuple(n.var_assigns), n.sync_after)
    if n.kind == "loop":
        trips = (("unroll", next(iter(n.trips))) if len(n.trips) == 1
                 else ("dyn", gp.trip_slot[uid]))
        return base + (n.body.sig(), trips,
                       tuple(sorted(n.body.var_binds.items())))
    return base


def _items_sig(gp, sp, items, R) -> Tuple:
    out = []
    for item in items:
        if isinstance(item, NodeItem):
            out.append(("node",) + _node_sig(gp, item.uid, R))
        elif isinstance(item, SwitchItem):
            fetches, vars_, exports = gp.switch_spec(item, sp)
            out.append(("switch", R(item.fork_uid),
                        gp.selector_slot[item.fork_uid], R(item.join_uid),
                        tuple(R(c) for c in item.child_order),
                        tuple((R(u), oi) for u, oi in fetches),
                        tuple(vars_),
                        tuple((R(u), oi) for u, oi in exports),
                        tuple(_items_sig(gp, sp, b, R)
                              for b in item.branches)))
        else:
            raise TypeError(f"unknown item {item!r}")
    return tuple(out)


def segment_signature(gp, sp) -> Tuple:
    """Structural identity of one segment's compiled function.

    Node uids are **canonicalized** to dense segment-local ids assigned in
    deterministic traversal order (items first, then the IO lists), so two
    structurally identical segments match even when their graphs numbered
    the nodes differently — notably across *family members* (sibling
    shape-class TraceGraphs, DESIGN.md §8) whose uid spaces are disjoint
    histories.  Safety: the remap is a bijection applied uniformly, every
    ordering the compiled function's calling convention depends on (carry
    and feed positions, var-id lists, global selector/trip slot indices)
    is kept in raw form, and everything shape-dependent (out avals, feed
    avals) stays in the key — equal canonical signatures therefore imply
    the same computation with the same calling convention."""
    remap: Dict[int, int] = {}

    def R(uid: int) -> int:
        r = remap.get(uid)
        if r is None:
            r = remap[uid] = len(remap)
        return r

    return (
        _items_sig(gp, sp, sp.items, R),
        tuple(sp.var_reads), tuple(sp.var_writes),
        tuple(sp.don_var_ids), tuple(sp.keep_var_ids),
        tuple((R(u), oi) for u, oi in sp.carries_in),
        tuple((R(u), oi) for u, oi in sp.carries_out),
        tuple((R(u), pos, aval) for u, pos, aval in sp.feed_keys),
        tuple((R(u), oi) for u, oi in sp.fetch_keys),
    )


class SegmentCache:
    """signature -> compiled segment callable, with hit/miss counters.

    ``hits``/``misses`` are cumulative over the engine's lifetime; the
    coordinator mirrors them into ``engine.stats`` as
    ``segment_cache_hits`` / ``segments_recompiled`` after every
    GraphProgram (re)generation.
    """

    def __init__(self):
        self._fns: Dict[Tuple, Any] = {}
        self.hits = 0
        self.misses = 0
        self.persist = None         # PersistLayer, set by the coordinator

    def get_or_build(self, key: Tuple, builder: Callable[[], Any],
                     loader: Callable[[], Any] = None) -> Any:
        """In-memory probe, then the optional ``loader`` (the persist
        layer's on-disk AOT executable — counted as a HIT: nothing is
        recompiled), then ``builder`` (a real recompile, counted as a
        miss)."""
        fn = self._fns.get(key)
        if fn is not None:
            self.hits += 1
            return fn
        if loader is not None:
            fn = loader()
            if fn is not None:
                self._fns[key] = fn
                self.hits += 1
                return fn
        fn = builder()
        self._fns[key] = fn
        self.misses += 1
        return fn

    def retain(self, keys) -> None:
        """Evict every entry whose signature is not in ``keys`` — the
        union of segment signatures over every *live family's* current
        GraphProgram (families.live_signatures), not just the newest
        program: per-program retention would evict sibling shape classes'
        callables on every regeneration.  Each cached fn closes over its
        originating GraphProgram, so without eviction every version bump
        would pin a full old program (and, on the card, its CUDA graphs,
        which go with the last reference); and because each family's
        TraceGraph only grows (nodes, fetch annotations, trip sets are
        append-only), a signature absent from every live program can only
        recur through a re-created evicted family — eviction bounds memory
        to the live segment set at the cost of that rare recompile.  The
        persist layer is notified of the drop: its on-disk AOT
        executables survive, so a re-created family reloads instead of
        recompiling (DESIGN.md §14)."""
        dropped = [k for k in self._fns if k not in keys]
        if dropped and self.persist is not None:
            self.persist.on_segments_evicted(dropped)
        for k in dropped:
            del self._fns[k]

    def __len__(self) -> int:
        return len(self._fns)
