"""TraceGraph: merging iteration traces into a DAG (paper §4.2, Fig. 3).

Node equality follows Appendix A — (op type, attributes, program location) —
extended with *input-source identity*: two dynamic ops merge into one node
only if they also consumed the same producers.  This conservative extension
(DESIGN.md §7.1) removes the need for path-dependent phi resolution
everywhere except variable bindings and makes the generated switch regions
provably consistent: a post-join node can never consume a branch-interior
value (if it did, its input sources would differ per path and it would not
have merged).

Loop rolling (paper: "the GraphGenerator merges the nodes that are executed
in the same loop ... because it compares the program location"): tandem
repeats of identical signature blocks in a trace are rolled into a LoopEntry
with an explicit carried-state analysis; rolled loops merge into LoopNodes
whose trip counts are tracked per trace.  Constant trip counts are unrolled
at generation time (the paper's unrolling optimization); varying trip counts
become a dynamic `fori_loop` with the trip count fed by the PythonRunner
(the paper's *Loop Cond* mechanism).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.trace import (Aval, FeedRef, Ref, SyncMarker, Trace,
                              TraceEntry, VarAssign, VarRef)
from repro_torch.core.ops import Const

START, END = "start", "end"


# --------------------------------------------------------------------------
# Sources: path-independent input identities in the merged graph
# --------------------------------------------------------------------------
# ('node', uid, out_idx) | ('feed', Aval) | ('var', var_id) | ('const', v)
# | ('carry', k)  (inside rolled loop bodies: k-th loop-carried slot)
# | ('inv', src)  (inside rolled loop bodies: loop-invariant outer source)

Src = Tuple


@dataclasses.dataclass
class TGNode:
    uid: int
    kind: str                           # 'op' | 'start' | 'end' | 'loop'
    op_name: str = ""
    attrs: Tuple = ()
    location: Tuple[str, int] = ("", 0)
    srcs: Tuple[Src, ...] = ()
    out_avals: Tuple[Aval, ...] = ()
    children: List[int] = dataclasses.field(default_factory=list)
    fetch_idxs: set = dataclasses.field(default_factory=set)  # materialized out_idxs
    sync_after: bool = False            # gating fetch => segment boundary
    var_assigns: Tuple[Tuple[int, int], ...] = ()   # (var_id, out_idx)
    # loop-node fields
    body: Optional["LoopBody"] = None
    trips: set = dataclasses.field(default_factory=set)
    # Walker fast path (DESIGN.md §4.4): hash of the last merged TraceEntry
    # that matched this node (op/attrs/location + raw input refs + feed
    # avals).  A steady-state iteration revalidates the op with one hash
    # comparison against this stamp; any mismatch falls back to the full
    # structural comparison below — never straight to divergence.
    entry_stamp: Optional[int] = None
    _sig_cache: Optional[Tuple] = dataclasses.field(default=None, repr=False)
    _uchildren: Tuple = dataclasses.field(default=(-1, ()), repr=False)

    def sig(self) -> Tuple:
        # srcs/attrs/body are fixed at node creation, so the signature (and
        # its hash, used by merge matching) is computed exactly once
        s = self._sig_cache
        if s is None:
            if self.kind == "loop":
                s = ("loop", self.location, self.body.sig(), self.srcs)
            else:
                s = (self.op_name, self.attrs, self.location, self.srcs)
            self._sig_cache = s
        return s

    def uniq_children(self) -> Tuple[int, ...]:
        """Order-preserving deduped children, memoized until an edge is
        appended (the Walker calls this once per validated op)."""
        n, cached = self._uchildren
        if n == len(self.children):
            return cached
        seen: set = set()
        out = []
        for c in self.children:
            if c not in seen:
                seen.add(c)
                out.append(c)
        cached = tuple(out)
        self._uchildren = (len(self.children), cached)
        return cached


def clone_node(n: TGNode) -> TGNode:
    """Copy one node for rewrite (see TraceGraph.clone_for_rewrite):
    mutable containers are duplicated, caches reset, loop bodies shared
    (passes never rewrite inside rolled bodies)."""
    c = TGNode(n.uid, n.kind, op_name=n.op_name, attrs=n.attrs,
               location=n.location, srcs=n.srcs, out_avals=n.out_avals,
               children=list(n.children), fetch_idxs=set(n.fetch_idxs),
               sync_after=n.sync_after, var_assigns=n.var_assigns,
               body=n.body, trips=set(n.trips))
    if hasattr(n, "_last_ordinals"):
        c._last_ordinals = n._last_ordinals
    return c


@dataclasses.dataclass
class LoopBody:
    """Linear body of a rolled loop.

    entries[i].srcs_local use ('carry', k) / ('inv', m) / ('const', v) /
    ('var', var_id) / ('node', local_idx, out_idx) encodings local to the
    body.  carries: list of (init_outer_src, (local_producer_idx, out_idx)):
    slot k is initialized from the outer source and re-bound each trip to the
    local producer's output.  invariants: outer srcs (pre-merge encoding)
    read unchanged every trip.  var_binds: var_id -> carry slot (variables
    re-assigned every trip; their final value is the loop output).
    """
    entries: List[TraceEntry] = dataclasses.field(default_factory=list)
    carries: List[Tuple[Src, Tuple[int, int]]] = dataclasses.field(default_factory=list)
    invariants: List[Src] = dataclasses.field(default_factory=list)
    var_binds: Dict[int, int] = dataclasses.field(default_factory=dict)

    def sig(self) -> Tuple:
        return (tuple(e.signature() + (e.srcs_local,) for e in self.entries),
                tuple((c[1],) for c in self.carries),
                len(self.invariants),
                tuple(sorted(self.var_binds.items())))


class TraceGraph:
    """The merged DAG of all collected traces — of ONE shape class.

    The engine keeps a *family* of TraceGraphs keyed by the iteration's
    shape-class signature (executor/families.py, DESIGN.md §8); versioning
    is per family: ``version`` only advances when this graph itself merges
    something new, never when a sibling shape class traces.  ``family_key``
    records which shape class this graph describes (None for graphs built
    outside the family machinery, e.g. in tests)."""

    def __init__(self, family_key=None):
        self.family_key = family_key
        self.nodes: Dict[int, TGNode] = {}
        self._next_uid = 0
        self.start = self._new(TGNode(0, START))
        self.end = self._new(TGNode(0, END))
        self.version = 0
        # final variable binding per trace path is resolved at walk time; the
        # graph records which vars are ever assigned (for output slots)
        self.assigned_vars: set = set()
        self.read_vars: set = set()

    # -- construction ------------------------------------------------------
    def _new(self, node: TGNode) -> TGNode:
        node.uid = self._next_uid
        self._next_uid += 1
        self.nodes[node.uid] = node
        return node

    def children_of(self, uid: int) -> List[TGNode]:
        return [self.nodes[c] for c in self.nodes[uid].children]

    # -- merge (paper Fig. 3) ------------------------------------------------
    def merge_trace(self, trace: Trace, rolled_events: List[Any]) -> bool:
        """Merge one (rolled) trace.  Returns True iff the trace was already
        fully covered (no new nodes/edges/annotations) — the paper's tracing
        phase termination condition."""
        changed = False
        cursor = self.start
        ord_to_uid: Dict[int, int] = {}

        for ev in rolled_events:
            if isinstance(ev, SyncMarker):
                uid = self._resolve_ref_uid(ev.ref, ord_to_uid)
                if uid is not None:
                    n = self.nodes[uid]
                    if n.kind == "loop":
                        oi = n.body.out_slot_for(
                            ev.ref, getattr(n, "_last_ordinals", ()))
                    else:
                        oi = ev.ref.out_idx
                    if oi not in n.fetch_idxs or not n.sync_after:
                        changed = True
                    n.fetch_idxs.add(oi)
                    n.sync_after = True
                continue
            if isinstance(ev, VarAssign):
                # annotate on the producing node
                self.assigned_vars.add(ev.var_id)
                uid = self._resolve_ref_uid(ev.ref, ord_to_uid)
                if uid is not None:
                    n = self.nodes[uid]
                    if n.kind == "loop":
                        # rolled loops encode assignments in body.var_binds
                        continue
                    oi = ev.ref.out_idx
                    if (ev.var_id, oi) not in n.var_assigns:
                        n.var_assigns = n.var_assigns + ((ev.var_id, oi),)
                        changed = True
                continue

            if isinstance(ev, LoopEntry):
                srcs = tuple(self._resolve_src(s, ord_to_uid) for s in ev.outer_srcs)
                sig = ("loop", ev.location, ev.body.sig(), srcs)
                nxt = self._match_or_create(cursor, sig, lambda: TGNode(
                    0, "loop", location=ev.location, srcs=srcs,
                    out_avals=ev.out_avals, body=ev.body))
                node, created = nxt
                if created:
                    changed = True
                if ev.trips not in node.trips:
                    node.trips.add(ev.trips)
                    changed = True
                ord_to_uid.update({o: node.uid for o in ev.ordinals})
                node._last_ordinals = ev.ordinals  # for ref resolution
                cursor = node
                continue

            # plain TraceEntry
            e: TraceEntry = ev
            srcs = tuple(self._resolve_src_ref(r, i, e, ord_to_uid)
                         for i, r in enumerate(e.input_refs))
            for r in e.input_refs:
                if isinstance(r, VarRef):
                    self.read_vars.add(r.var_id)
            sig = (e.op_name, e.attrs, e.location, srcs)
            node, created = self._match_or_create(cursor, sig, lambda: TGNode(
                0, "op", op_name=e.op_name, attrs=e.attrs, location=e.location,
                srcs=srcs, out_avals=e.out_avals))
            if created:
                changed = True
            node.entry_stamp = e.stamp()    # Walker fast path (§4.4)
            ord_to_uid[e._ordinal] = node.uid
            cursor = node

        # close to END
        if self.end.uid not in self.nodes[cursor.uid].children:
            self.nodes[cursor.uid].children.append(self.end.uid)
            changed = True
        if changed:
            self.version += 1
        self.last_ord_to_uid = ord_to_uid
        return not changed

    def _match_or_create(self, cursor: TGNode, sig: Tuple, make) -> Tuple[TGNode, bool]:
        # 1) among children of the latest matched node
        for c in self.children_of(cursor.uid):
            if c.kind in ("op", "loop") and c.sig() == sig:
                return c, False
        # 2) merge-back: any equal node elsewhere (paper's branch re-merge)
        for n in self.nodes.values():
            if n.kind in ("op", "loop") and n.sig() == sig:
                self.nodes[cursor.uid].children.append(n.uid)
                return n, True
        # 3) new branch
        node = self._new(make())
        self.nodes[cursor.uid].children.append(node.uid)
        return node, True

    def _resolve_src_ref(self, r, arg_pos: int, e: TraceEntry, ord_to_uid) -> Src:
        if isinstance(r, Ref):
            uid = ord_to_uid[r.entry]
            n = self.nodes[uid]
            if n.kind == "loop":
                # output of a rolled loop = its carried slot's final value
                k = n.body.out_slot_for(r, getattr(n, "_last_ordinals", ()))
                return ("node", uid, k)
            return ("node", uid, r.out_idx)
        if isinstance(r, FeedRef):
            aval = dict(e.feed_avals).get(arg_pos)
            return ("feed", aval)
        if isinstance(r, VarRef):
            return ("var", r.var_id)
        if isinstance(r, Const):
            return ("const", r.value)
        raise TypeError(f"unknown ref {r!r}")

    def _resolve_src(self, s, ord_to_uid) -> Src:
        # outer srcs of rolled loops come pre-encoded with trace ordinals
        if s[0] == "ord":
            _, ordn, out_idx = s
            return ("node", ord_to_uid[ordn], out_idx)
        return s

    def _resolve_ref_uid(self, r, ord_to_uid) -> Optional[int]:
        if isinstance(r, Ref) and r.entry in ord_to_uid:
            return ord_to_uid[r.entry]
        return None

    # -- rewrite support (core/passes/) --------------------------------------
    def clone_for_rewrite(self) -> "TraceGraph":
        """Uid-preserving copy for the optimization passes (DESIGN.md §10).

        The clone shares immutable per-node state (attrs, avals, loop
        bodies) but owns fresh ``srcs`` tuples, children lists and
        annotation sets, so passes can rewrite sources, clear gating flags
        and splice hoisted nodes without ever touching the graph the
        Walker validates against.  ``version``/``family_key`` carry over;
        signature caches are dropped (srcs may be rewritten)."""
        g = TraceGraph.__new__(TraceGraph)
        g.family_key = self.family_key
        g.nodes = {uid: clone_node(n) for uid, n in self.nodes.items()}
        g._next_uid = self._next_uid
        g.start = g.nodes[self.start.uid]
        g.end = g.nodes[self.end.uid]
        g.version = self.version
        g.assigned_vars = set(self.assigned_vars)
        g.read_vars = set(self.read_vars)
        return g

    def splice_before(self, uid: int, node: TGNode) -> TGNode:
        """Insert ``node`` immediately before ``uid`` in the CFG (edge
        split): every parent edge into ``uid`` is redirected through the
        new node.  Only legal on a rewrite clone — fork children lists
        keep their order (the Case Select mapping), because ``uid``
        itself may be a fork child and the new node takes its slot."""
        node = self._new(node)
        for p in self.nodes.values():
            if p is node:
                continue
            p.children = [node.uid if c == uid else c for c in p.children]
            p._uchildren = (-1, ())
        node.children = [uid]
        return node

    # -- queries -------------------------------------------------------------
    def forks(self) -> List[int]:
        return [u for u, n in self.nodes.items()
                if n.kind != "end" and len(set(n.children)) > 1]

    def n_ops(self) -> int:
        return sum(1 for n in self.nodes.values() if n.kind in ("op", "loop"))


# --------------------------------------------------------------------------
# Loop rolling (tandem-repeat detection + carried-state analysis)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LoopEntry:
    """A rolled loop occurrence inside one trace."""
    location: Tuple[str, int]
    body: LoopBody
    trips: int
    outer_srcs: Tuple[Src, ...]       # ('ord', ordinal, out_idx)|('feed',..)|...
    out_avals: Tuple[Aval, ...]       # final carried values
    ordinals: Tuple[int, ...]         # trace ordinals of all rolled entries


MAX_PERIOD = 8
MIN_TRIPS = 2


def roll_loops(trace: Trace) -> List[Any]:
    """Post-process a trace: collapse tandem-repeated op blocks into
    LoopEntries.  Conservative: a block rolls only if (a) signatures repeat
    exactly, (b) cross-instance dataflow forms a consistent carried-state
    pattern, (c) no feeds / fetches / var reads that vary per trip other
    than through carries, (d) no sync markers inside."""
    events = trace.events
    # Assign ordinals to entries in event order
    ordn = 0
    for ev in events:
        if isinstance(ev, TraceEntry):
            ev._ordinal = ordn
            ordn += 1

    # only entries participate in rolling; markers break blocks
    out: List[Any] = []
    i = 0
    while i < len(events):
        ev = events[i]
        if not isinstance(ev, TraceEntry):
            out.append(ev)
            i += 1
            continue
        rolled = _try_roll_at(events, i, trace)
        if rolled is not None:
            entry, consumed = rolled
            out.append(entry)
            i += consumed
        else:
            out.append(ev)
            i += 1
    return out


def _sig_at(events, i):
    ev = events[i]
    if not isinstance(ev, TraceEntry):
        return None
    return ev.signature()


def _try_roll_at(events, i, trace):
    best = None
    for p in range(1, MAX_PERIOD + 1):
        # block = events[i : i+p]; count tandem repeats
        if i + 2 * p > len(events):
            break
        sig0 = [_sig_at(events, i + k) for k in range(p)]
        if any(s is None for s in sig0):
            break
        reps = 1
        while True:
            base = i + reps * p
            if base + p > len(events):
                break
            sigr = [_sig_at(events, base + k) for k in range(p)]
            if sigr != sig0:
                break
            reps += 1
        if reps >= MIN_TRIPS:
            le = _analyze_block(events, i, p, reps, trace)
            if le is not None and (best is None or p * reps > best[1] * best[2]):
                best = (le, p, reps)
    if best is None:
        return None
    le, p, reps = best
    return le, p * reps


def make_out_slot_for(body: LoopBody, ordinals: Sequence[int]):
    """Build a LoopBody's ``out_slot_for`` closure: maps a Ref into the
    rolled region to the carry slot it produces (0 when not carried).

    ``ordinals`` are the trace ordinals of every rolled entry in
    instance-major order — _analyze_block passes the ordinals of the
    trace being rolled; persist/codec.py passes the node's persisted
    ``_last_ordinals`` to rebuild the closure after a round-trip
    (closures don't serialize, and ordinals restart at 0 per trace, so
    a warm process resolves refs into the hydrated loop identically)."""
    carry_key = {prod: k for k, (_, prod) in enumerate(body.carries)}
    p = max(1, len(body.entries))
    inst_ords = [{o: j for j, o in enumerate(ordinals[r:r + p])}
                 for r in range(0, len(ordinals), p)]

    def out_slot_for(ref, _ordinals, _ck=carry_key, _iords=inst_ords):
        # a Ref into the rolled region maps to the carry slot it produces
        for ords in _iords:
            if isinstance(ref, Ref) and ref.entry in ords:
                prod = (ords[ref.entry], ref.out_idx)
                if prod in _ck:
                    return _ck[prod]
        return 0
    return out_slot_for


def _analyze_block(events, i, p, reps, trace):
    """Validate the carried-state structure of a tandem repeat and build a
    LoopEntry, or return None if inconsistent.

    Classification of every input slot, per instance r:
      internal:  produced by the same instance            -> ('node', j, oi)
      carried:   produced by instance r-1, consistently   -> ('carry', k)
      invariant: identical outer Ref/const/var every trip -> ('inv', m) etc.
    """
    insts = [[events[i + r * p + k] for k in range(p)] for r in range(reps)]
    all_ordinals = tuple(e._ordinal for inst in insts for e in inst)
    inst_ords = [{e._ordinal: j for j, e in enumerate(inst)} for inst in insts]

    carries: List[Tuple[Src, Tuple[int, int]]] = []
    carry_key: Dict[Tuple[int, int], int] = {}   # (local_idx, oi) -> slot
    invariants: List[Src] = []
    inv_key: Dict[Src, int] = {}

    def as_outer(ref) -> Optional[Src]:
        if isinstance(ref, Ref):
            return ("ord", ref.entry, ref.out_idx)
        if isinstance(ref, VarRef):
            return ("var", ref.var_id)
        if isinstance(ref, Const):
            return ("const", ref.value)
        return None   # FeedRef: per-trip feeds unsupported in rolled loops

    body_entries = []
    for j, e in enumerate(insts[0]):
        locals_srcs = []
        for pos, first in enumerate(e.input_refs):
            if isinstance(first, Ref) and first.entry in inst_ords[0]:
                # internal — must be the same local slot in every instance
                loc_idx = inst_ords[0][first.entry]
                for r in range(1, reps):
                    fr = insts[r][j].input_refs[pos]
                    if not (isinstance(fr, Ref) and fr.entry in inst_ords[r]
                            and inst_ords[r][fr.entry] == loc_idx
                            and fr.out_idx == first.out_idx):
                        return None
                locals_srcs.append(("node", loc_idx, first.out_idx))
                continue
            # carried? instance r>=1 consumes instance r-1's local (j', oi)
            carried_prod = None
            is_carried = reps > 1
            for r in range(1, reps):
                fr = insts[r][j].input_refs[pos]
                if not (isinstance(fr, Ref) and fr.entry in inst_ords[r - 1]):
                    is_carried = False
                    break
                pj = (inst_ords[r - 1][fr.entry], fr.out_idx)
                if carried_prod is None:
                    carried_prod = pj
                elif carried_prod != pj:
                    return None
            if is_carried:
                init = as_outer(first)
                if init is None:
                    return None
                slot = carry_key.get(carried_prod)
                if slot is None:
                    slot = len(carries)
                    carries.append((init, carried_prod))
                    carry_key[carried_prod] = slot
                elif carries[slot][0] != init:
                    return None
                locals_srcs.append(("carry", slot))
                continue
            # invariant — identical in every instance
            for r in range(1, reps):
                if insts[r][j].input_refs[pos] != first:
                    return None
            if isinstance(first, Const):
                locals_srcs.append(("const", first.value))
            elif isinstance(first, VarRef):
                locals_srcs.append(("var", first.var_id))
            elif isinstance(first, Ref):
                src = as_outer(first)
                m = inv_key.get(src)
                if m is None:
                    m = len(invariants)
                    invariants.append(src)
                    inv_key[src] = m
                locals_srcs.append(("inv", m))
            else:
                return None   # FeedRef
        be = dataclasses.replace(e)
        be.srcs_local = tuple(locals_srcs)
        body_entries.append(be)

    if not carries:
        return None   # no carried state: keep unrolled

    body = LoopBody(entries=body_entries, carries=carries,
                    invariants=list(invariants))

    # fetches of rolled entries are only recoverable if they are the final
    # trip's carried outputs (post-loop materialization); mid-loop gating
    # fetches never reach here because SyncMarker events break the tandem
    # block contiguity.
    fetched = {r.entry for r in trace.fetches if isinstance(r, Ref)}
    for o in all_ordinals:
        if o in fetched:
            if o not in inst_ords[reps - 1]:
                return None     # fetch of a non-final trip value
            j = inst_ords[reps - 1][o]
            if not any(prod[0] == j for prod in carry_key):
                return None     # fetched value is not a carried output
    # var assigns inside the block must bind to carried producers
    for ev in trace.events:
        if (isinstance(ev, VarAssign) and isinstance(ev.ref, Ref)
                and ev.ref.entry in set(all_ordinals)):
            bound = False
            for r in range(reps):
                if ev.ref.entry in inst_ords[r]:
                    prod = (inst_ords[r][ev.ref.entry], ev.ref.out_idx)
                    if prod in carry_key:
                        body.var_binds[ev.var_id] = carry_key[prod]
                        bound = True
                    break
            if not bound:
                return None

    out_avals = tuple(
        body_entries[prod[0]].out_avals[prod[1]] for (_, prod) in carries)
    outer = tuple(init for (init, _) in carries) + tuple(invariants)
    body.out_slot_for = make_out_slot_for(body, all_ordinals)

    loc = body_entries[0].location
    return LoopEntry(location=loc, body=body, trips=reps, outer_srcs=outer,
                     out_avals=out_avals, ordinals=all_ordinals)
