"""The PythonRunner surface: op recording and Output Fetching.

This mixin is the side of the engine the instrumented op layer talks to
(paper §4.1's PythonRunner): ``record_op`` is called for every DL op the
Python interpreter executes — eagerly executed and recorded while tracing,
validated through the Walker and turned into placeholder tensors while
co-executing — and ``materialize`` resolves a placeholder at a fetch point
against the active dispatcher's futures, escalating to path-specialized
chain dispatch or the divergence fallback when the graph does not already
output the value.

It is a mixin rather than a standalone object because it *is* the engine's
public op-facing API — separated from coordinator.py only so the phase
machine and the recording surface stay independently readable.
"""

from __future__ import annotations

import time
from typing import Any, Dict

from repro_torch.core import ops as ops_mod
from repro_torch.core.ops import Const
from repro_torch.core.tensor import TerraTensor
from repro_torch.core.trace import (Aval, FeedRef, Ref, SyncMarker,
                                    TraceEntry, VarRef, is_tensor_like)
from repro_torch.core.executor.dispatch import ChainDispatcher
from repro_torch.core.executor.walker import DivergenceError, ReplayRequired

SKELETON = "skeleton"


class PythonRunnerOps:
    """Mixin for TerraEngine: the op-recording / fetching surface."""

    # ------------------------------------------------------------------
    # op recording (called from ops._call_op)
    # ------------------------------------------------------------------
    def record_op(self, name: str, args, attrs_t, loc):
        refs, vals = [], []
        feed_avals: list = []
        feed_values: Dict[int, Any] = {}
        ordinal = len(self.trace.entries)
        for pos, (kind, a) in enumerate(args):
            if kind == "tensor":
                t = a
                if t.ref is None or t._iter != self.iter_id:
                    # value from outside this iteration — becomes a feed
                    v = t._eager if t._eager is not None else t.value()
                    refs.append(FeedRef(ordinal, pos))
                    feed_avals.append((pos, Aval.of(v)))
                    feed_values[pos] = v
                    self._feed_log[(ordinal, pos)] = v
                    vals.append(v)
                else:
                    refs.append(t.ref)
                    vals.append(t._eager)
            elif kind == "const":
                refs.append(Const(a))
                vals.append(a)
            else:  # feed
                refs.append(FeedRef(ordinal, pos))
                feed_avals.append((pos, Aval.of(a)))
                feed_values[pos] = a
                self._feed_log[(ordinal, pos)] = a
                vals.append(a)

        entry = TraceEntry(op_name=name, attrs=attrs_t, location=loc,
                           input_refs=tuple(refs), out_avals=(),
                           feed_avals=tuple(feed_avals))

        if self.mode == SKELETON:
            try:
                avals, uid = self.walker.advance(entry, ordinal, feed_values)
            except DivergenceError as e:
                self._fallback_replay(str(e))
                # placeholders now hold concrete values — rebuild the args
                vals = self._vals_for_entry(entry, ordinal)
                return self._exec_eager(entry, ordinal, vals)
            entry.out_avals = avals
            self.trace.add_entry(entry)
            outs = tuple(
                TerraTensor(Ref(ordinal, oi), avals[oi], engine=self,
                            iter_id=self.iter_id)
                for oi in range(len(avals)))
            for oi, t in enumerate(outs):
                self._tensors[(ordinal, oi)] = t
            if self.walker.boundary_reached is not None:
                seg = self.walker.boundary_reached
                self.walker.boundary_reached = None
                self.walker.seg_idx = seg + 1
                self.dispatcher.on_boundary(seg)
            return outs if len(outs) > 1 else outs[0]

        return self._exec_eager(entry, ordinal, vals)

    def _vals_for_entry(self, entry: TraceEntry, ordinal: int):
        vals = []
        for pos, r in enumerate(entry.input_refs):
            if isinstance(r, Ref):
                vals.append(self._vals[(r.entry, r.out_idx)])
            elif isinstance(r, FeedRef):
                vals.append(self._feed_log[(ordinal, pos)])
            elif isinstance(r, VarRef):
                # read_initial: a divergence rollback may have removed the
                # seed buffer of a variable first registered this iteration
                vals.append(self.store.read_initial(r.var_id))
            elif isinstance(r, Const):
                vals.append(r.value)
        return vals

    def _exec_eager(self, entry: TraceEntry, ordinal: int, vals):
        # feeds arrive as host data: stage them onto the engine's device
        stage = self.store.stage
        vals = [stage(v) if is_tensor_like(v) else v for v in vals]
        out = ops_mod.OPS[entry.op_name].impl(*vals, **dict(entry.attrs))
        outs = out if isinstance(out, tuple) else (out,)
        entry.out_avals = tuple(Aval.of(o) for o in outs)
        self.trace.add_entry(entry)
        ts = tuple(TerraTensor(Ref(ordinal, oi), entry.out_avals[oi],
                               eager=o, engine=self, iter_id=self.iter_id)
                   for oi, o in enumerate(outs))
        for oi, t in enumerate(ts):
            self._tensors[(ordinal, oi)] = t
            self._vals[(ordinal, oi)] = outs[oi]
        return ts if len(ts) > 1 else ts[0]

    # ------------------------------------------------------------------
    # tape support (GradientTape reads the recorded trace back out)
    # ------------------------------------------------------------------
    def tape_mark(self) -> int:
        return len(self.trace.entries)

    def tape_slice(self, start: int):
        entries = [(i, e) for i, e in enumerate(self.trace.entries[start:],
                                                start=start)]

        def tensors_of(ordinal):
            e = self.trace.entries[ordinal]
            return [self._tensors[(ordinal, oi)]
                    for oi in range(len(e.out_avals))]
        return entries, tensors_of

    def tensors_for_input_slots(self, ordinal: int, entry: TraceEntry):
        out = []
        for pos, r in enumerate(entry.input_refs):
            if isinstance(r, Ref):
                out.append(self._tensors[(r.entry, r.out_idx)])
            elif isinstance(r, FeedRef):
                out.append(self._feed_log[(ordinal, pos)])
            elif isinstance(r, VarRef):
                var = self.vars[r.var_id]
                t = TerraTensor(VarRef(r.var_id), var.aval, engine=self,
                                iter_id=self.iter_id)
                if self.mode != SKELETON:
                    t._eager = self.store.get(r.var_id, var._value)
                out.append(t)
            elif isinstance(r, Const):
                out.append(r.value)
        return out

    # ------------------------------------------------------------------
    # materialization (Output Fetching)
    # ------------------------------------------------------------------
    def materialize(self, t: TerraTensor):
        if t._eager is not None:
            return t._eager
        if t._future is not None:
            # a fetch future was attached when the producing iteration
            # closed: the value is awaitable even after later iterations
            # started (lag-harvest; steady-state outputs carry only this)
            return self._await(t, t._future)
        ref = t.ref
        if isinstance(ref, VarRef):
            return self.variable_value(self.vars[ref.var_id])
        if t._iter != self.iter_id or self.mode != SKELETON:
            # stale placeholder from an earlier iteration
            raise RuntimeError("placeholder escaped its iteration without "
                               "being fetch-marked")
        if self._iter_open:
            self.trace.events.append(SyncMarker(ref))
        self.trace.fetches.append(ref)
        try:
            uid, oi = self.walker.uid_of(ref)
        except ReplayRequired:
            self._recover_value()
            return t._eager
        node = self.tg.nodes[uid]
        if self.dispatcher.kind == "chain":
            # chains output every produced value — no replay needed even
            # for never-before-seen fetches (annotate for future graphs)
            node.fetch_idxs.add(oi)
            fut = self.dispatcher.future_for(ref)
            if fut is None and self._iter_open:
                try:
                    self.dispatcher.flush()
                except ReplayRequired:
                    # the chain needed a value the optimized segments no
                    # longer publish (DCE'd): recover via eager replay
                    self._recover_value()
                    return t._eager
                fut = self.dispatcher.future_for(ref)
            if fut is not None:
                return self._await(t, fut)
            self._recover_value()
            return t._eager
        if oi not in node.fetch_idxs:
            # never-before-seen fetch: annotate & recover via replay
            node.fetch_idxs.add(oi)
            if self._iter_open:
                node.sync_after = True
            self.tg.version += 1
            self._recover_value()
            return t._eager
        fut = self.dispatcher.future_for(ref)
        if fut is None and self._iter_open:
            # fetch gates Python mid-segment (e.g. inside a branch region):
            # switch to path-specialized dispatch — run the exact walked
            # chain instead of replaying eagerly (DESIGN.md §2)
            self.dispatcher = ChainDispatcher(self.dispatcher,
                                              self._feed_log,
                                              self._chain_cache)
            try:
                self.dispatcher.flush()
            except ReplayRequired:
                self._recover_value()
                return t._eager
            fut = self.dispatcher.future_for(ref)
        if fut is None:
            self._recover_value()
            return t._eager
        return self._await(t, fut)

    def _await(self, t: TerraTensor, fut):
        with self.events.span("engine.fetch", it=self.iter_id):
            t0 = time.perf_counter()
            if self.runner.lazy:
                self.runner.run_pending_now()
            v = fut.result()
            self.events.add("py_stall_time", time.perf_counter() - t0)
        t._eager = v
        return v

    def note_fetch(self, t: TerraTensor):
        """Record a fetch point observed while the value was already eager
        (tracing phase, or post-replay).  Paper §4.2: fetch points are
        captured during tracing and annotated in the TraceGraph."""
        ref = t.ref
        if not isinstance(ref, Ref):
            return
        if t._iter == self.iter_id and self._iter_open:
            self.trace.events.append(SyncMarker(ref))
            self.trace.fetches.append(ref)
        elif t._iter == self.iter_id and not self._iter_open:
            # materialized after the iteration closed (e.g. the returned
            # loss): annotate the merged node as a non-gating fetch
            ord_map = getattr(self.tg, "last_ord_to_uid", None)
            if ord_map and ref.entry in ord_map:
                n = self.tg.nodes[ord_map[ref.entry]]
                oi = (n.body.out_slot_for(ref, ()) if n.kind == "loop"
                      else ref.out_idx)
                if oi not in n.fetch_idxs:
                    n.fetch_idxs.add(oi)
                    self.tg.version += 1
