"""Walker: the PythonRunner's TraceGraph cursor (paper §4.1).

As the skeleton program executes, every DL op is *validated* against the
TraceGraph ("continuously compares the trace with the TraceGraph"): the
Walker advances a cursor through the merged DAG, resolving Case Select
values at forks, Loop Cond trip counts at rolled loops, and collecting
Input Feeding values.  A mismatch raises :class:`DivergenceError`, which the
coordinator turns into the divergence fallback (executor/fallback.py).

The Walker is (almost) a pure consumer of the TraceGraph — fetch
annotation stays in the coordinator, and it holds only per-iteration
cursor state, so a fresh Walker is built at every skeleton iteration
start.  The one exception is warm boot (core/persist/, DESIGN.md §14):
nodes hydrated from the artifact store carry ``entry_stamp=None``
(process-salted hashes don't persist), and the Walker re-stamps them as
it structurally validates each one on the first iteration.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.ops import Const
from repro_torch.core.trace import (Aval, FeedRef, Ref, TraceEntry, VarRef,
                                    as_tensor)


def feed_stager(device):
    """How collected Input Feeding values are staged (DESIGN.md §4.4):
    every feed becomes a tensor on the engine's device the moment the
    Walker collects it, so the host→device copy is issued during skeleton
    execution instead of inside dispatch.  On the CPU numpy data is shared,
    not copied."""
    return lambda v: as_tensor(v, device)


class DivergenceError(Exception):
    """Raised by the Walker when the current trace escapes the TraceGraph."""


class ReplayRequired(Exception):
    """Materialization needs a value the symbolic graph does not output."""


class _LoopState:
    def __init__(self, node):
        self.node = node
        self.body = node.body
        self.pos = 0
        self.trips = 0
        self.prev_prod: Dict[Tuple[int, int], int] = {}  # local (j,oi) -> ordinal
        self.cur_prod: Dict[Tuple[int, int], int] = {}
        self.entry_ordinals: List[int] = []


class Walker:
    """Advances through the TraceGraph as the skeleton executes, recording
    Case Select / Loop Cond / Input Feeding values and detecting new
    traces."""

    def __init__(self, gp):
        self.gp = gp
        self.tg = gp.tg             # validation runs on the ORIGINAL graph
        self.cursor = self.tg.start.uid
        self.region_stack: List[int] = []      # join uids
        self.seg_idx = 0
        self.sels: Dict[int, int] = {}
        self.trips: Dict[int, int] = {}
        self.feed_vals: Dict[Tuple[int, int], Any] = {}
        # raw (unstaged) feed objects, for identity checks by the steady-
        # state planner: (uid, pos) -> the exact value the skeleton passed
        self.feed_raw: Dict[Tuple[int, int], Any] = {}
        self.ord_to_uid: Dict[int, int] = {}
        self.loop: Optional[_LoopState] = None
        self.boundary_reached: Optional[int] = None
        self.fast_hits = 0          # ops validated via the stamp fast path
        self.fold_misses = 0        # folded-feed value mismatches (→ diverge)
        # segment boundaries follow the OPTIMIZED graph (coalescing may
        # have cleared gating flags); identical to the sync_after set when
        # optimization is off
        self._boundaries = gp.boundary_uids
        self._folded = gp.folded_feeds
        self._stage = feed_stager(gp.device)

    # -- src resolution (must mirror TraceGraph.merge_trace) --------------
    def _src_of(self, ref, pos, entry):
        if isinstance(ref, Ref):
            uid = self.ord_to_uid.get(ref.entry)
            if uid is None:
                raise DivergenceError("ref to unknown producer")
            n = self.tg.nodes[uid]
            if n.kind == "loop":
                return ("node", uid, n.body.out_slot_for(ref, ()))
            return ("node", uid, ref.out_idx)
        if isinstance(ref, FeedRef):
            return ("feed", dict(entry.feed_avals).get(pos))
        if isinstance(ref, VarRef):
            return ("var", ref.var_id)
        if isinstance(ref, Const):
            return ("const", ref.value)
        raise DivergenceError(f"unknown ref {ref!r}")

    def _entry_sig(self, entry: TraceEntry):
        srcs = tuple(self._src_of(r, i, entry)
                     for i, r in enumerate(entry.input_refs))
        return (entry.op_name, entry.attrs, entry.location, srcs)

    # -- loop-body matching -------------------------------------------------
    def _match_body_entry(self, ls: _LoopState, entry: TraceEntry) -> bool:
        body, j = ls.body, ls.pos
        if j >= len(body.entries):
            return False
        be = body.entries[j]
        if (entry.op_name, entry.attrs, entry.location) != (
                be.op_name, be.attrs, be.location):
            return False
        n_car = len(body.carries)
        for pos, (ref, s) in enumerate(zip(entry.input_refs, be.srcs_local)):
            kind = s[0]
            if kind == "node":
                if not (isinstance(ref, Ref)
                        and ls.cur_prod.get((s[1], s[2])) == ref.entry):
                    return False
            elif kind == "carry":
                init_src, prod = body.carries[s[1]]
                if ls.trips == 0:
                    want = self.gp.tg.nodes[ls.node.uid].srcs[s[1]]
                    if self._src_of(ref, pos, entry) != want:
                        return False
                else:
                    if not (isinstance(ref, Ref)
                            and ls.prev_prod.get(prod) == ref.entry):
                        return False
            elif kind == "inv":
                want = self.gp.tg.nodes[ls.node.uid].srcs[n_car + s[1]]
                if self._src_of(ref, pos, entry) != want:
                    return False
            elif kind == "const":
                if not (isinstance(ref, Const) and ref.value == s[1]):
                    return False
            elif kind == "var":
                if not (isinstance(ref, VarRef) and ref.var_id == s[1]):
                    return False
            else:
                return False
        return True

    def _loop_step(self, ls: _LoopState, entry: TraceEntry, ordinal: int):
        j = ls.pos
        for oi in range(len(ls.body.entries[j].out_avals)):
            ls.cur_prod[(j, oi)] = ordinal
        ls.cur_prod.setdefault((j, -1), ordinal)
        ls.entry_ordinals.append(ordinal)
        ls.pos += 1
        if ls.pos == len(ls.body.entries):
            ls.trips += 1
            ls.pos = 0
            ls.prev_prod = ls.cur_prod
            ls.cur_prod = {}
        return ls.body.entries[j].out_avals

    def _exit_loop(self):
        ls = self.loop
        n = ls.node
        if ls.pos != 0:
            raise DivergenceError("loop exited mid-body")
        if len(n.trips) == 1:
            if ls.trips != next(iter(n.trips)):
                raise DivergenceError("unrolled loop trip-count changed")
        else:
            self.trips[n.uid] = ls.trips
        for o in ls.entry_ordinals:
            self.ord_to_uid[o] = n.uid
        n._last_ordinals = tuple(ls.entry_ordinals)
        self.loop = None
        self.cursor = n.uid

    # -- main advance ---------------------------------------------------------
    def advance(self, entry: TraceEntry, ordinal: int,
                feed_values: Dict[int, Any]) -> Tuple[Tuple[Aval, ...], int]:
        """Validate one op; returns (out_avals, node_uid or body marker).

        Steady-state fast path (DESIGN.md §4.4): every merged node carries
        the hash of the trace entry that last matched it; when the current
        entry's stamp equals a child's stamp the op is accepted with that
        single comparison.  A stamp mismatch falls back to the full
        structural source comparison below — never straight to divergence.
        """
        if self.loop is not None:
            ls = self.loop
            if self._match_body_entry(ls, entry):
                avals = self._loop_step(ls, entry, ordinal)
                return avals, ls.node.uid
            if ls.pos == 0:
                self._exit_loop()       # try to continue after the loop
            else:
                raise DivergenceError("loop body mismatch")

        nodes = self.tg.nodes
        children = nodes[self.cursor].uniq_children()
        if not children:
            raise DivergenceError("walk past end of TraceGraph")

        stamp = entry.stamp()
        if stamp is not None:
            hit = None
            for i, cuid in enumerate(children):
                n = nodes[cuid]
                if n.kind == "loop":
                    # a loop child takes precedence over op siblings in
                    # the structural scan (the entry may open a rolled
                    # body) — abandon the fast path so precedence is
                    # decided structurally, exactly as before
                    hit = None
                    break
                if n.kind == "op" and n.entry_stamp == stamp:
                    if hit is not None:
                        # ambiguous stamp among siblings: two per-path
                        # nodes after a branch re-merge carry identical
                        # raw trace entries (the stamp omits resolved
                        # srcs, which is the only thing telling them
                        # apart) — accepting the first would record the
                        # wrong Case Select and silently compute the
                        # other branch's dataflow.  Resolve structurally.
                        hit = None
                        break
                    hit = (n, i)
            if hit is not None:
                self.fast_hits += 1
                return self._accept(hit[0], hit[1], len(children), ordinal,
                                    feed_values)

        sig = self._entry_sig(entry)
        matched_idx = None
        for i, cuid in enumerate(children):
            n = nodes[cuid]
            if n.kind == "op" and n.sig() == sig:
                matched_idx = i
                break
            if n.kind == "loop":
                ls = _LoopState(n)
                if (entry.op_name, entry.attrs, entry.location) == (
                        n.body.entries[0].op_name, n.body.entries[0].attrs,
                        n.body.entries[0].location):
                    self.loop = ls
                    if self._match_body_entry(ls, entry):
                        matched_idx = i
                        break
                    self.loop = None
        if matched_idx is None:
            raise DivergenceError(
                f"no TraceGraph node matches {entry.op_name} at "
                f"{entry.location}")
        cuid = children[matched_idx]
        node = nodes[cuid]
        if node.kind == "op" and node.entry_stamp is None and \
                stamp is not None:
            # hydrated graphs arrive without stamps — hash() is salted
            # per process, so persisted stamps could never match
            # (persist/codec.py).  Re-stamp on the first structural
            # acceptance so iteration 2 regains the fast path.
            node.entry_stamp = stamp
        if node.kind == "loop":
            if len(children) > 1:
                self.sels[self.cursor] = matched_idx
                join = self.gp.structure.ipdom.get(self.cursor)
                if join is not None:
                    self.region_stack.append(join)
            stage = self._stage
            for pos, v in feed_values.items():
                self.feed_vals[(cuid, pos)] = stage(v)
                self.feed_raw[(cuid, pos)] = v
            avals = self._loop_step(self.loop, entry, ordinal)
            # cursor stays; region bookkeeping on exit
            return avals, cuid
        return self._accept(node, matched_idx, len(children), ordinal,
                            feed_values)

    def _accept(self, node, matched_idx: int, n_children: int, ordinal: int,
                feed_values: Dict[int, Any]) -> Tuple[Tuple[Aval, ...], int]:
        """Commit one validated op node: selector / region bookkeeping,
        Input Feeding collection (values go device-side immediately so the
        host→device transfer overlaps skeleton execution), cursor move and
        segment-boundary detection."""
        cuid = node.uid
        if n_children > 1:
            self.sels[self.cursor] = matched_idx
            join = self.gp.structure.ipdom.get(self.cursor)
            if join is not None:
                self.region_stack.append(join)
        if feed_values:
            stage = self._stage
            folded = self._folded
            for pos, v in feed_values.items():
                if folded:
                    fc = folded.get((cuid, pos))
                    if fc is not None:
                        # constant-folded Input Feed (passes/feed_fold.py):
                        # the baked value must still match — a mismatch is
                        # a divergence, which re-enters tracing, marks the
                        # slot varying and restores the feed at the next
                        # regeneration
                        if not fc.equals(v):
                            self.fold_misses += 1
                            raise DivergenceError(
                                f"folded Input Feed ({cuid}, {pos}) "
                                f"changed value")
                        continue
                self.feed_vals[(cuid, pos)] = stage(v)
                self.feed_raw[(cuid, pos)] = v
        self.ord_to_uid[ordinal] = cuid
        self.cursor = cuid
        rs = self.region_stack
        while rs and rs[-1] == cuid:
            rs.pop()
        if cuid in self._boundaries and not rs:
            self.boundary_reached = self.seg_idx
        return node.out_avals, cuid

    def taken_uids(self) -> set:
        """Uids of every TraceGraph node validated (taken) so far this
        iteration — used by the dispatcher to tell a legitimately-defaulted
        feed (untaken branch region) from a collection bug on the walked
        path (DESIGN.md §4.4 strict-feeds check)."""
        taken = set(self.ord_to_uid.values())
        if self.loop is not None:
            taken.add(self.loop.node.uid)
        return taken

    # -- finishing -------------------------------------------------------------
    def at_end(self) -> bool:
        if self.loop is not None:
            if self.loop.pos != 0:
                return False
            self._exit_loop()
        return self.tg.end.uid in self.tg.nodes[self.cursor].children

    def uid_of(self, ref: Ref) -> Tuple[int, int]:
        uid = self.ord_to_uid.get(ref.entry)
        if uid is None:
            raise ReplayRequired()
        n = self.tg.nodes[uid]
        if n.kind == "loop":
            return uid, n.body.out_slot_for(ref, ())
        return uid, ref.out_idx
