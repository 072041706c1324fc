"""Symbolic graph generation: TraceGraph -> executable segment callables.

The GraphGenerator (paper §4.2) converts the merged TraceGraph into the
symbolic graph the GraphRunner executes:

* each TraceGraph op node -> its registered torch impl,
* fork nodes -> the branch picked by the *Case Select* input
  (``selectors[slot]``, a host-side value the PythonRunner provides, so
  choosing a branch never reads the device),
* rolled loop nodes -> unrolled when every collected trace agrees on the
  trip count (the paper's unrolling optimization), otherwise a Python loop
  whose trip count is a *Loop Cond* input,
* feed points -> *Input Feeding*: function inputs filled by the
  PythonRunner each iteration,
* fetch points -> *Output Fetching*: function outputs the PythonRunner
  materializes on demand,
* Variables -> resource inputs/outputs threaded through the GraphRunner's
  device-resident store.

The program is cut into *segments* at gating fetch points (DESIGN.md §2 —
the compiled-graph adaptation of TF's mid-graph blocking ops); values
produced in one segment and consumed in a later one are carried through
explicit carry inputs/outputs.

A segment is a Python callable that runs its ops under ``torch.no_grad()``
on the engine's device.  On a CUDA card "compiling" a segment wraps that
callable in a :class:`~repro_torch.core.capture.CapturedFn` — the port's
``jax.jit``: warmed up once, then captured into a CUDA graph and replayed
(core/capture.py); on the CPU, under ``capture.disable_jit()``, or when
the segment holds an op registered as not capturable, it stays eager.
``segments_recompiled`` counts callables built.

Two compile-time analyses shape the callable:

* **Liveness.**  The last top-level consumer of every value is computed
  once; ``_interp`` drops a value from the segment's environment right
  after it, so a segment holds only its live set (the counterpart of
  XLA's buffer liveness, and the size of a captured graph's pool).
  Carries out stay; fetches and variable writes are held by their own
  buffers.
* **Donation** (``_analyze_donation``, DESIGN.md §4.2).  A variable in
  ``don_var_ids`` gets its new value written into the donated input's
  storage, so the store keeps one buffer per variable; a written value
  that a later segment will donate is made sole-owner first (cloned when
  it shares storage with any other input or output).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import capture as capture_mod
from repro_torch.core import ops as ops_mod
from repro_torch.core.casing import NodeItem, Structure, SwitchItem
from repro_torch.core.passes.analysis import FoldedConst
from repro_torch.core.trace import Aval, as_tensor
from repro_torch.core.tracegraph import TGNode, TraceGraph

Key = Tuple[int, int]           # (uid, out_idx) — a produced value
FeedKey = Tuple[int, int]       # (uid, arg_pos) — an Input Feeding slot


def _zeros(aval: Aval, device):
    return torch.zeros(aval.shape, dtype=aval.dtype, device=device)


@dataclasses.dataclass
class SegProg:
    index: int
    items: list
    var_reads: List[int]
    var_writes: List[int]
    carries_in: List[Key]
    carries_out: List[Key]
    feed_keys: List[Tuple[int, int, Aval]]
    fetch_keys: List[Key]
    fn: Any = None                   # segment callable
    # donation split of var_reads: ``don_var_ids`` buffers receive the
    # variable's new value in place (safe only for intermediates produced
    # earlier in the same iteration — see _analyze_donation / DESIGN.md
    # §4.2); ``owned_writes`` are the writes a later segment will donate
    don_var_ids: List[int] = dataclasses.field(default_factory=list)
    keep_var_ids: List[int] = dataclasses.field(default_factory=list)
    owned_writes: List[int] = dataclasses.field(default_factory=list)
    signature: Any = None            # structural key for the segment cache
    # uid -> canonical segment-local id, filled with the signature (the
    # persist layer writes AOT artifacts in canonical ids, aot.py)
    canon: Dict[int, int] = dataclasses.field(default_factory=dict)
    plan: "DispatchPlan" = None      # precomputed dispatch layout (§4.4)


@dataclasses.dataclass(frozen=True)
class SegmentBuild:
    """What :meth:`GraphProgram._segment_fn` needs beyond the graph and
    the segment's IO contract: the item list, the liveness (env keys to
    drop after each top-level item), whether every op may be captured,
    and the Case Select / Loop Cond slots the segment reads on the host.
    Computed by :meth:`GraphProgram.segment_build`, or decoded from a
    persisted AOT artifact on a warm boot (core/persist/aot.py)."""
    items: list
    frees: Tuple[Tuple[Key, ...], ...]
    capturable: bool
    sel_slots: Tuple[int, ...]
    trip_slots: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Flat per-segment dispatch layout, precomputed at compile time
    (DESIGN.md §4.4).

    Everything ``SegmentDispatcher.dispatch_through`` needs per iteration is
    baked into tuples here — selector/trip slot orders (fork/loop uids in
    globally assigned slot order), the Input Feeding layout, and the
    variable read order split into the donated and retained halves — so the
    per-iteration hot path is straight array fills with no sorting and no
    dict probing."""
    sel_uids: Tuple[int, ...]        # fork uids in selector-slot order
    trip_uids: Tuple[int, ...]       # loop uids in trip-slot order
    feed_keys: Tuple[Tuple[int, int, Aval], ...]
    don_var_ids: Tuple[int, ...]
    keep_var_ids: Tuple[int, ...]
    var_writes: Tuple[int, ...]
    carries_in: Tuple[Key, ...]
    carries_out: Tuple[Key, ...]
    fetch_keys: Tuple[Key, ...]
    kernel_ops: Tuple[str, ...] = ()  # kernel-substituted ops in the segment
    #                                   (pass metadata for profiling events)


class GraphProgram:
    """Executable artifact for one version of one family's TraceGraph.

    ``family_key`` is the shape-class signature the program was generated
    under (DESIGN.md §8); sibling shape classes get sibling GraphPrograms,
    and structurally identical segments are shared between them through
    the engine-lifetime SegmentCache (canonical-uid signatures)."""

    def __init__(self, tg: TraceGraph, var_avals: Dict[int, Aval],
                 jit_each: bool = True, seg_cache=None, family_key=None,
                 opt=None, device=None, capture=None):
        # ``tg`` stays the Walker-facing graph (validation, stamps,
        # divergence); ``otg`` is what this program COMPILES — the pass
        # pipeline's rewrite clone when optimization is on (uids
        # preserved, so walker-collected selector/trip/feed values key
        # straight into the optimized plans), otherwise tg itself.
        self.tg = tg
        self.opt = opt
        # where folded feeds and switch phi zeros are made
        self.device = torch.device("cpu") if device is None else device
        # the engine's CaptureContext (CUDA only); None compiles eager
        self.capture = (capture if capture is not None and jit_each
                        and not capture_mod.jit_disabled() else None)
        self._folded_dev: Dict[int, Any] = {}   # id(FoldedConst) -> tensor
        self.otg = opt.otg if opt is not None else tg
        self.version = tg.version
        self.opt_token = None       # set by the coordinator (passes cache)
        self.family_key = (family_key if family_key is not None
                           else tg.family_key)
        self.structure = Structure(self.otg)
        self.var_avals = var_avals
        self._switch_specs: Dict[Tuple[int, int], Tuple] = {}
        self._dead = opt.dead if opt is not None else ()
        self._alias = opt.alias_nodes if opt is not None else {}
        self.folded_feeds = opt.folded if opt is not None else {}

        otg_nodes = self.otg.nodes
        # ---- slot assignment (Case Select / Loop Cond inputs) -----------
        self.selector_slot: Dict[int, int] = {}
        self.trip_slot: Dict[int, int] = {}
        for item in self.structure.iter_items():
            if isinstance(item, SwitchItem):
                self.selector_slot.setdefault(item.fork_uid,
                                              len(self.selector_slot))
            elif isinstance(item, NodeItem):
                n = otg_nodes[item.uid]
                if n.kind == "loop" and len(n.trips) != 1:
                    self.trip_slot.setdefault(item.uid, len(self.trip_slot))
        self.n_selectors = len(self.selector_slot)
        self.n_trips = len(self.trip_slot)

        # ---- global consumer map (used for switch-region exports) --------
        # effective sources: dead nodes consume nothing, alias nodes
        # consume their representative (passes/__init__.OptResult)
        self.consumers: Dict[Key, set] = {}
        for uid, n in otg_nodes.items():
            if n.kind not in ("op", "loop"):
                continue
            for s in self._eff_srcs(n):
                if s[0] == "node":
                    self.consumers.setdefault((s[1], s[2]), set()).add(uid)

        # ---- per-segment IO analysis -------------------------------------
        segs = list(self.structure.segments)
        if opt is not None and opt.drop_empty_trailing and segs \
                and not segs[-1]:
            segs.pop()              # coalesce pass: no-op trailing segment
        produced_in: Dict[Key, int] = {}
        consumed: List[set] = [set() for _ in segs]
        for si, seg in enumerate(segs):
            for uid in self.structure.uids_in(seg):
                n = otg_nodes[uid]
                if uid in self._dead:
                    continue
                for oi in range(self._n_out(n)):
                    produced_in[(uid, oi)] = si
                for s in self._eff_srcs(n):
                    if s[0] == "node":
                        consumed[si].add((s[1], s[2]))

        self.seg_progs: List[SegProg] = []
        self.feed_slot: Dict[FeedKey, Tuple[int, int]] = {}
        self.fetch_slot: Dict[Key, Tuple[int, int]] = {}

        feed_moved = opt.feed_moved if opt is not None else {}
        for si, seg in enumerate(segs):
            uids = self.structure.uids_in(seg)
            var_reads, var_writes = set(), set()
            feed_keys: List[Tuple[int, int, Aval]] = []
            feed_consumers: List[FeedKey] = []
            fetch_keys: List[Key] = []
            for uid in uids:
                n = otg_nodes[uid]
                if uid in self._dead:
                    continue
                if uid not in self._alias:
                    for pos, s in enumerate(n.srcs):
                        if s[0] == "var":
                            var_reads.add(s[1])
                        elif s[0] == "feed":
                            # dispatch keys follow the Walker's collection
                            # slot — the ORIGINAL consumer when kernel
                            # substitution moved the source
                            fk = feed_moved.get((uid, pos), (uid, pos))
                            feed_keys.append((fk[0], fk[1], s[1]))
                            feed_consumers.append((uid, pos))
                for (vid, oi) in n.var_assigns:
                    var_writes.add(vid)
                if n.kind == "loop" and n.body is not None:
                    var_writes.update(n.body.var_binds.keys())
                for oi in sorted(n.fetch_idxs):
                    fetch_keys.append((uid, oi))
            later = set().union(*consumed[si + 1:]) if si + 1 < len(segs) else set()
            carries_in = sorted(k for k in consumed[si]
                                if produced_in.get(k, si) < si)
            carries_out = sorted(k for k in later
                                 if produced_in.get(k, -1) == si)
            for j, ck in enumerate(feed_consumers):
                self.feed_slot[ck] = (si, j)    # exec-time lookup key
            for j, k in enumerate(fetch_keys):
                self.fetch_slot[k] = (si, j)
            sp = SegProg(si, seg, sorted(var_reads | var_writes),
                         sorted(var_writes), carries_in, carries_out,
                         feed_keys, fetch_keys)
            self.seg_progs.append(sp)

        # ---- donation analysis + compilation (through the segment cache) --
        self._analyze_donation()
        self.donatable_var_ids = {v for sp in self.seg_progs
                                  for v in sp.don_var_ids}
        # ---- dispatch plans: bake the per-iteration layout (§4.4) --------
        sel_uids = tuple(u for u, _ in sorted(self.selector_slot.items(),
                                              key=lambda kv: kv[1]))
        trip_uids = tuple(u for u, _ in sorted(self.trip_slot.items(),
                                               key=lambda kv: kv[1]))
        for sp in self.seg_progs:
            kernel_ops = tuple(
                otg_nodes[uid].op_name
                for uid in self.structure.uids_in(sp.items)
                if uid not in self._dead and uid not in self._alias
                and otg_nodes[uid].op_name.startswith("kernel."))
            sp.plan = DispatchPlan(
                sel_uids, trip_uids, tuple(sp.feed_keys),
                tuple(sp.don_var_ids), tuple(sp.keep_var_ids),
                tuple(sp.var_writes), tuple(sp.carries_in),
                tuple(sp.carries_out), tuple(sp.fetch_keys), kernel_ops)
        for sp in self.seg_progs:
            if seg_cache is not None:
                from repro_torch.core.executor.segment_cache import \
                    segment_signature
                # signatures are computed strictly POST-pass (over the
                # optimized graph + dead/alias/fold state), so a segment
                # whose optimized form is unchanged is a cache hit even
                # when coalescing or folding reshaped its neighbours
                sp.signature = (jit_each, self.capture is not None,
                                tuple(sp.owned_writes),
                                segment_signature(self, sp, sp.canon))
                persist = seg_cache.persist
                if persist is not None:
                    # warm boot (DESIGN.md §14): consult the on-disk AOT
                    # artifact before compiling; a fresh compile writes
                    # its artifact back into the store
                    sp.fn = seg_cache.get_or_build(
                        sp.signature,
                        lambda sp=sp: persist.build_segment(self, sp,
                                                            jit_each),
                        loader=lambda sp=sp: persist.load_segment(
                            self, sp, jit_each))
                else:
                    sp.fn = seg_cache.get_or_build(
                        sp.signature,
                        lambda sp=sp: self._compile_segment(sp, jit_each))
            else:
                sp.fn = self._compile_segment(sp, jit_each)

        # Walker-facing boundary set (optimized sync flags) and the value
        # keys dispatched segments publish to iter_env (chain dispatch
        # checks ext availability against this, dispatch.py)
        self.boundary_uids = {uid for uid, n in otg_nodes.items()
                              if n.sync_after}
        self.published = {k for sp in self.seg_progs for k in sp.carries_out}

    # ------------------------------------------------------------------
    def _node(self, uid: int) -> TGNode:
        return self.otg.nodes[uid]

    def _eff_srcs(self, n: TGNode) -> Tuple:
        if self.opt is not None:
            return self.opt.eff_srcs(n)
        return n.srcs

    # ------------------------------------------------------------------
    def _final_var_products(self, sp: SegProg) -> Dict[int, Optional[Key]]:
        """vid -> (uid, oi) producing its final value in this segment, or
        None when the producer is ambiguous / potentially buffer-aliased
        (switch phi outputs)."""
        prods: Dict[int, Optional[Key]] = {}
        for item in sp.items:
            if isinstance(item, NodeItem):
                n = self._node(item.uid)
                if item.uid in self._dead:
                    continue
                alias = self._alias.get(item.uid)
                if n.kind == "loop" and n.body is not None:
                    for vid, slot in n.body.var_binds.items():
                        prods[vid] = (n.uid, slot)
                for vid, oi in n.var_assigns:
                    # an alias node's write is backed by its
                    # representative's buffer, which may also travel as a
                    # cross-segment carry THIS segment's escape set cannot
                    # see — treat like a switch phi: never donatable
                    prods[vid] = None if alias is not None else (n.uid, oi)
            else:       # SwitchItem: per-path producers; switch phi outputs
                _, interior_vars, _ = self.switch_spec(item, sp)
                for vid in interior_vars:
                    prods[vid] = None
        return prods

    def _analyze_donation(self) -> None:
        """Static per-segment donation eligibility for variable buffers.

        A segment may donate ``var_in[v]`` only when (a) it also writes v
        (so the backend has an output to alias the buffer into), and (b) the buffer
        it will read is an *intermediate* of this same iteration — produced
        by an earlier segment — whose sole owner is the variable store.
        Iteration-start buffers are never donatable: the divergence snapshot
        holds them for rollback.  A producing value that is also a fetch
        output or a carry (or a switch phi, or shared by two variables)
        escapes the store, so it is retained and never donated either.
        So does a buffer that a segment between its writer and its donor
        reads as a kept input: torch ops return views, and a fetch, carry
        or write of that segment may be a view of the buffer, which the
        donation would overwrite (JAX's outputs never alias its inputs).
        Reads after a write bind to the writer's product when tracing, so
        such a read does not arise from a traced program.
        """
        # vid -> retained?  (present only once some segment wrote the vid)
        last_write: Dict[int, bool] = {}
        writer: Dict[int, SegProg] = {}
        for sp in self.seg_progs:
            writes = set(sp.var_writes)
            don = [v for v in sp.var_reads
                   if v in writes and last_write.get(v) is False]
            sp.don_var_ids = don
            don_set = set(don)
            sp.keep_var_ids = [v for v in sp.var_reads if v not in don_set]
            for v in don:
                writer[v].owned_writes.append(v)
            for v in sp.keep_var_ids:
                if v in last_write:
                    last_write[v] = True

            prods = self._final_var_products(sp)
            seen_products: Dict[Key, int] = {}
            escaped = set(sp.fetch_keys) | set(sp.carries_out)
            for v in sp.var_writes:
                p = prods.get(v)
                retained = p is None or p in escaped
                if p is not None:
                    if p in seen_products:      # two vars share one buffer
                        retained = True
                        last_write[seen_products[p]] = True
                    seen_products[p] = v
                last_write[v] = retained
                writer[v] = sp

    def _liveness(self, sp: SegProg) -> List[Tuple[Key, ...]]:
        """Keys to drop from the segment's env after each top-level item:
        every value after its last consumer (or right after its producer
        when no item of the segment consumes it), except carries out."""
        def consumed(uid):
            if uid in self._dead:
                return ()
            alias = self._alias.get(uid)
            if alias is not None:
                return alias
            return [(s[1], s[2]) for s in self._node(uid).srcs
                    if s[0] == "node"]

        last: Dict[Key, int] = {k: -1 for k in sp.carries_in}
        for i, item in enumerate(sp.items):
            if isinstance(item, NodeItem):
                uids = [item.uid]
                if item.uid not in self._dead:
                    for oi in range(self._n_out(self._node(item.uid))):
                        last[(item.uid, oi)] = i
            else:
                uids = [u for b in item.branches
                        for u in self.structure.uids_in(b)]
                for k in self.switch_spec(item, sp)[2]:
                    last[k] = i
            for uid in uids:
                for k in consumed(uid):
                    if k in last:
                        last[k] = i
        frees: List[List[Key]] = [[] for _ in sp.items]
        keep = set(sp.carries_out)
        for k, i in last.items():
            if k not in keep and i >= 0:
                frees[i].append(k)
        return [tuple(f) for f in frees]

    # ------------------------------------------------------------------
    def _n_out(self, n: TGNode) -> int:
        if n.kind == "loop":
            return len(n.body.carries)
        return len(n.out_avals)

    # ------------------------------------------------------------------
    def _compile_segment(self, sp: SegProg, jit_each: bool):
        # ``jit_each`` stays part of the segment signature for parity with
        # the reference; ``self.capture`` already folds it in
        return self._segment_fn(sp, self.segment_build(sp))

    def segment_build(self, sp: SegProg) -> SegmentBuild:
        """The compile-time analyses of one segment (liveness,
        capturability, host slots)."""
        sels, trips = self._host_slots(sp.items)
        return SegmentBuild(sp.items, tuple(self._liveness(sp)),
                            self._capturable(sp.items), tuple(sels),
                            tuple(trips))

    def _segment_fn(self, sp: SegProg, build: SegmentBuild):
        """The segment callable: ``build``'s items run under
        ``torch.no_grad()`` with its liveness, wrapped for capture when
        the engine captures and every op may be captured."""
        items, frees = build.items, build.frees

        @torch.no_grad()
        def seg_fn(don_var_in: tuple, keep_var_in: tuple, feeds: tuple,
                   sels, trips, carries_in: tuple):
            env: Dict[Key, Any] = dict(zip(sp.carries_in, carries_in))
            var_start = dict(zip(sp.don_var_ids, don_var_in))
            var_start.update(zip(sp.keep_var_ids, keep_var_in))
            ctx = {
                "env": env,
                "var_start": var_start,
                "var_env": dict(var_start),
                "fetch_buf": {},
                "feeds": feeds,
                "sels": sels,
                "trips": trips,
            }
            self._interp(items, sp, ctx, frees)
            var_env = ctx["var_env"]
            fetches = [ctx["fetch_buf"][k] for k in sp.fetch_keys]
            carries_out = [env[k] for k in sp.carries_out]
            if sp.owned_writes or sp.don_var_ids:
                _donate(sp, var_start, var_env, fetches, carries_out,
                        tuple(feeds) + tuple(carries_in))
            var_out = tuple(var_env[v] for v in sp.var_writes)
            return var_out, tuple(fetches), tuple(carries_out)

        if self.capture is None:
            return seg_fn
        if not build.capturable:
            return self.capture.eager(seg_fn)
        sel_slots, trip_slots = build.sel_slots, build.trip_slots

        def host(don, keep, feeds, sels, trips, carries):
            return (tuple(int(sels[j]) for j in sel_slots),
                    tuple(int(trips[j]) for j in trip_slots))

        # arg 0 carries exactly the donation-eligible buffers (may be empty)
        return self.capture.wrap(seg_fn, donate=(0,), host=host)

    def _capturable(self, items) -> bool:
        for uid in self.structure.uids_in(items):
            if uid in self._dead or uid in self._alias:
                continue
            n = self._node(uid)
            names = ([e.op_name for e in n.body.entries] if n.kind == "loop"
                     else [n.op_name])
            if not all(ops_mod.OPS[m].capturable for m in names):
                return False
        return True

    def _host_slots(self, items) -> Tuple[List[int], List[int]]:
        """The Case Select and Loop Cond slots a segment reads: part of its
        graph key, since branches and trip counts are chosen on the host."""
        sels, trips = set(), set()

        def walk(its):
            for item in its:
                if isinstance(item, SwitchItem):
                    sels.add(self.selector_slot[item.fork_uid])
                    for b in item.branches:
                        walk(b)
                elif item.uid in self.trip_slot:
                    trips.add(self.trip_slot[item.uid])

        walk(items)
        return sorted(sels), sorted(trips)

    # ------------------------------------------------------------------
    def _resolve(self, src, sp: SegProg, ctx, uid: int, pos: int):
        kind = src[0]
        if kind == "node":
            return ctx["env"][(src[1], src[2])]
        if kind == "feed":
            si, j = self.feed_slot[(uid, pos)]
            assert si == sp.index
            return ctx["feeds"][j]
        if kind == "var":
            return ctx["var_start"][src[1]]
        if kind == "const":
            v = src[1]
            # a constant-folded feed (passes/feed_fold.py) bakes its value
            # behind a hashable wrapper; unwrap onto the device
            if isinstance(v, FoldedConst):
                t = self._folded_dev.get(id(v))
                if t is None:
                    t = self._folded_dev[id(v)] = as_tensor(v.value,
                                                            self.device)
                return t
            return v
        raise ValueError(f"unresolvable src {src}")

    # ------------------------------------------------------------------
    def _interp(self, items, sp: SegProg, ctx, frees=None):
        env = ctx["env"]
        for i, item in enumerate(items):
            if isinstance(item, NodeItem):
                self._exec_node(self._node(item.uid), sp, ctx)
            else:
                self._exec_switch(item, sp, ctx)
            if frees is not None:
                for k in frees[i]:
                    env.pop(k, None)

    # ------------------------------------------------------------------
    def _exec_node(self, n: TGNode, sp: SegProg, ctx):
        if n.uid in self._dead:
            return                  # DCE: computation skipped, CFG intact
        alias = self._alias.get(n.uid)
        if alias is not None:
            # CSE alias node: outputs are the representative's values;
            # fetch and Variable annotations still apply to them
            outs = tuple(ctx["env"][k] for k in alias)
            for oi, v in enumerate(outs):
                ctx["env"][(n.uid, oi)] = v
            for oi in n.fetch_idxs:
                ctx["fetch_buf"][(n.uid, oi)] = outs[oi]
            for vid, oi in n.var_assigns:
                ctx["var_env"][vid] = outs[oi]
            return
        if n.kind == "loop":
            self._exec_loop(n, sp, ctx)
            return
        vals = [self._resolve(s, sp, ctx, n.uid, pos)
                for pos, s in enumerate(n.srcs)]
        out = ops_mod.OPS[n.op_name].impl(*vals, **dict(n.attrs))
        outs = out if isinstance(out, tuple) else (out,)
        for oi, v in enumerate(outs):
            ctx["env"][(n.uid, oi)] = v
        for oi in n.fetch_idxs:
            ctx["fetch_buf"][(n.uid, oi)] = outs[oi]
        for vid, oi in n.var_assigns:
            ctx["var_env"][vid] = outs[oi]

    # ------------------------------------------------------------------
    def _exec_loop(self, n: TGNode, sp: SegProg, ctx):
        body = n.body
        n_car = len(body.carries)
        outer = [self._resolve(s, sp, ctx, n.uid, pos)
                 for pos, s in enumerate(n.srcs)]
        init = tuple(outer[:n_car])
        invs = tuple(outer[n_car:])

        def run_body(carry):
            lenv: Dict[Tuple[int, int], Any] = {}
            for j, e in enumerate(body.entries):
                vals = []
                for s in e.srcs_local:
                    if s[0] == "carry":
                        vals.append(carry[s[1]])
                    elif s[0] == "inv":
                        vals.append(invs[s[1]])
                    elif s[0] == "node":
                        vals.append(lenv[(s[1], s[2])])
                    elif s[0] == "const":
                        vals.append(s[1])
                    elif s[0] == "var":
                        vals.append(ctx["var_start"][s[1]])
                    else:
                        raise ValueError(f"bad body src {s}")
                out = ops_mod.OPS[e.op_name].impl(*vals, **dict(e.attrs))
                outs = out if isinstance(out, tuple) else (out,)
                for oi, v in enumerate(outs):
                    lenv[(j, oi)] = v
            return tuple(lenv[prod] for (_, prod) in body.carries)

        if len(n.trips) == 1:
            # constant trip count across all traces: unroll (paper's opt.)
            carry = init
            for _ in range(next(iter(n.trips))):
                carry = run_body(carry)
        else:
            # the Loop Cond trip count is a host-side feed value
            carry = init
            for _ in range(int(ctx["trips"][self.trip_slot[n.uid]])):
                carry = run_body(carry)
        for k in range(n_car):
            ctx["env"][(n.uid, k)] = carry[k]
        for oi in n.fetch_idxs:
            ctx["fetch_buf"][(n.uid, oi)] = carry[oi]
        for vid, slot_k in body.var_binds.items():
            ctx["var_env"][vid] = carry[slot_k]

    # ------------------------------------------------------------------
    def _aval_of(self, key: Key) -> Aval:
        n = self._node(key[0])
        if n.kind == "loop":
            return n.body.entries[n.body.carries[key[1]][1][0]].out_avals[
                n.body.carries[key[1]][1][1]]
        return n.out_avals[key[1]]

    def switch_spec(self, item: SwitchItem, sp: SegProg) -> Tuple:
        """Phi spec of a switch region: interior fetches (union over
        branches) + vars assigned in any branch + interior values consumed
        OUTSIDE this region (later same-path-only regions or later
        segments) — exported with zeros on non-producing branches, which is
        sound because only the producing path ever consumes them.  Shared
        by segment execution and the structural segment signature."""
        memo_key = (item.fork_uid, sp.index)
        spec = self._switch_specs.get(memo_key)
        if spec is not None:
            return spec
        tg = self.otg
        interior_fetch: List[Key] = []
        interior_vars: List[int] = []
        interior_uids: set = set()
        for b in item.branches:
            uids = set(self.structure.uids_in(b))
            interior_uids |= uids
            for uid in sorted(uids):
                if uid in self._dead:
                    continue
                n = tg.nodes[uid]
                for oi in sorted(n.fetch_idxs):
                    if (uid, oi) not in interior_fetch:
                        interior_fetch.append((uid, oi))
                for vid, _ in n.var_assigns:
                    if vid not in interior_vars:
                        interior_vars.append(vid)
                if n.kind == "loop" and n.body is not None:
                    for vid in n.body.var_binds:
                        if vid not in interior_vars:
                            interior_vars.append(vid)
        exports: List[Key] = []
        for uid in sorted(interior_uids):
            if uid in self._dead:
                continue
            n = tg.nodes[uid]
            for oi in range(self._n_out(n)):
                key = (uid, oi)
                cons = self.consumers.get(key, set())
                if (cons - interior_uids) or key in sp.carries_out:
                    exports.append(key)
        spec = (interior_fetch, interior_vars, exports)
        self._switch_specs[memo_key] = spec
        return spec

    def _exec_switch(self, item: SwitchItem, sp: SegProg, ctx):
        tg = self.otg
        interior_fetch, interior_vars, exports = self.switch_spec(item, sp)

        def mk_branch(bprog):
            def bf(_):
                bctx = dict(ctx)
                bctx["env"] = dict(ctx["env"])
                bctx["var_env"] = dict(ctx["var_env"])
                bctx["fetch_buf"] = dict(ctx["fetch_buf"])
                self._interp(bprog, sp, bctx)
                fouts = []
                for (uid, oi) in interior_fetch:
                    v = bctx["fetch_buf"].get((uid, oi))
                    if v is None:
                        v = _zeros(tg.nodes[uid].out_avals[oi], self.device)
                    fouts.append(v)
                vouts = [bctx["var_env"][vid] for vid in interior_vars]
                eouts = []
                for key in exports:
                    v = bctx["env"].get(key)
                    if v is None:
                        v = _zeros(self._aval_of(key), self.device)
                    eouts.append(v)
                return tuple(fouts) + tuple(vouts) + tuple(eouts)
            return bf

        # the Case Select value is a host-side feed: pick the branch in
        # Python (the reference's lax.switch clamps the index the same way)
        idx = int(ctx["sels"][self.selector_slot[item.fork_uid]])
        idx = min(max(idx, 0), len(item.branches) - 1)
        outs = mk_branch(item.branches[idx])(0)
        nf = len(interior_fetch)
        nv = len(interior_vars)
        for k, key in enumerate(interior_fetch):
            ctx["fetch_buf"][key] = outs[k]
        for k, vid in enumerate(interior_vars):
            ctx["var_env"][vid] = outs[nf + k]
        for k, key in enumerate(exports):
            ctx["env"][key] = outs[nf + nv + k]


def _shares(a, b) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _donate(sp: SegProg, var_start, var_env, fetches: list,
            carries: list, inputs: tuple) -> None:
    """Ownership epilogue of a segment (DESIGN.md §4.2).

    * A donated variable's new value goes into its input buffer, so the
      store keeps that buffer.  A fetch, carry or other write that is a
      view of the buffer is cloned first: JAX has no views, and a fetch of
      ``w[0]`` must not change when ``w`` is overwritten.
    * A written value that a later segment will donate must be owned by
      the store alone: one that shares storage with an input or another
      output of this segment is cloned."""
    for v in sp.don_var_ids:
        dst, new = var_start[v], var_env[v]
        if new is dst or new.shape != dst.shape or new.dtype != dst.dtype:
            continue                    # unchanged, or rebound to new aval
        if _shares(new, dst):
            new = new.clone()
        for outs in (fetches, carries):
            for j, t in enumerate(outs):
                if _shares(t, dst):
                    outs[j] = t.clone()
        for w in sp.var_writes:
            if w != v and _shares(var_env[w], dst):
                var_env[w] = var_env[w].clone()
        dst.copy_(new)
        var_env[v] = dst
    for v in sp.owned_writes:
        val = var_env[v]
        if val is var_start.get(v) and v in sp.don_var_ids:
            continue
        others = (fetches + carries + list(inputs)
                  + [t for w, t in var_start.items()]
                  + [var_env[w] for w in sp.var_writes if w != v])
        if any(isinstance(t, torch.Tensor) and _shares(val, t)
               for t in others):
            var_env[v] = val.clone()
