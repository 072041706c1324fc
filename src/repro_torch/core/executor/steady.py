"""Zero-walker steady-state dispatch (DESIGN.md §12).

Co-execution's per-iteration Python cost is the skeleton program itself:
even with the stamp fast path, every op re-executes Python-side to be
validated through the Walker.  For serving decode — one straight-line
segment repeated thousands of times with identical arg *structure* — that
cost is the whole gap to a hand-written jit dispatch loop.

The steady-state planner closes it: after ``steady_state`` consecutive
clean walker-validated iterations of one family whose shape is provably
replayable (single segment, no selects / loop conds / sync markers / rng /
folded feeds, every Input Feed identity-mapped to a call-arg leaf, every
output a graph-published fetch), the engine captures a :class:`SteadyPlan`
and subsequent calls dispatch the compiled segment straight from the
DispatchPlan — the user fn is **not executed** and no per-op validation
runs.  Outputs come back as placeholder tensors carrying only a fetch
future.

"Slower never wrong" is kept by construction where possible and by
probing where not: any structural miss (arg treedef / shape / dtype /
baked-constant change, variable-aval digest change, GraphProgram
regeneration, a ``_steady_poison`` mark from Python reading device state)
falls back to the full walker path, and every ``steady_probe``-th call is
forced through it so silent divergence cannot persist.  The one honest
caveat — documented, and why this is opt-in (``steady_state=0`` default):
Python side effects inside ``fn`` do not run on steady iterations, and a
*value*-dependent change of feed wiring inside ``fn`` is only caught at
the next probe.

A steady iteration takes no snapshot, so no rollback can need its
iteration-start buffers: it dispatches the segment's *twin*
(``GraphProgram.steady_twin``), which donates them and writes the
variables' new values in place (DESIGN.md §4.2).  Walker iterations,
probes included, keep the snapshot and the segment as compiled.
The engine's ``steady_donated_bytes`` counts the bytes the twin
donates; ``stats["donated_bytes"]`` stays the walker path's count.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple

from repro_torch.core.device import SegmentTimer
from repro_torch.core.events import emit as ev
from repro_torch.core.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.core.tensor import TerraTensor
from repro_torch.core.trace import Ref, SyncMarker, is_tensor_like
from repro_torch.core.executor.dispatch import _EMPTY_I32
from repro_torch.core.executor.walker import ReplayRequired

SKELETON = "skeleton"
MISS = object()        # sentinel: run the full walker path
_ABSENT = object()


@dataclasses.dataclass
class SteadyPlan:
    """Everything needed to dispatch one family's single segment without
    executing the skeleton: the feed wiring (arg-leaf index per DispatchPlan
    feed key), the argument validity signature, and the output spec."""
    gp: Any                         # GraphProgram identity guard
    sp: Any                         # its single SegProg
    feed_slots: Tuple[int, ...]     # leaf index per plan.feed_keys entry
    in_treedef: Any
    leaf_sigs: Tuple                # ("t", shape, dtype) | ("c", baked value)
    avals_digest: Any
    out_treedef: Any
    out_specs: Tuple                # ((uid, oi), aval) per output leaf
    last_leaves: Optional[List[Any]] = None    # identity fast path
    count: int = 0                  # steady calls, drives probe cadence
    twin: Any = None                # ``sp`` compiled to donate its reads


# ---------------------------------------------------------------------------
# observation (after each successful walker iteration)
# ---------------------------------------------------------------------------

def _build(eng, args, kwargs, out) -> Optional[SteadyPlan]:
    """Return a SteadyPlan if this just-finished walker iteration proves the
    family steady-eligible, else None.  Conservative on every axis: any
    structure the zero-walker replay could not reproduce exactly rejects."""
    if eng.mode != SKELETON or eng.walker is None or eng.dispatcher is None:
        return None
    if eng.dispatcher.kind != "segments":
        return None
    gp = eng.gp
    if gp is None or len(gp.seg_progs) != 1 or gp.folded_feeds:
        return None
    w = eng.walker
    if w.loop is not None or w.sels or w.trips:
        return None
    if eng._rng_count or getattr(eng, "_steady_poison", False):
        return None
    if any(isinstance(ev, SyncMarker) for ev in eng.trace.events):
        return None
    plan = gp.seg_progs[0].plan
    if plan.sel_uids or plan.trip_uids or plan.carries_in:
        return None
    try:
        leaves, in_treedef = tree_flatten((args, kwargs))
        out_leaves, out_treedef = tree_flatten(out)
    except Exception:
        return None
    sigs, by_id = [], {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, TerraTensor):
            return None             # cross-iteration placeholder args
        if is_tensor_like(leaf):
            sigs.append(("t", tuple(leaf.shape), str(leaf.dtype)))
        else:
            sigs.append(("c", leaf))
        by_id[id(leaf)] = i
    # every Input Feed must be the exact object of a call-arg leaf: a feed
    # derived in Python (mask.astype(...), a sliced frame) would be silently
    # stale under replay, so identity is the safety condition, not a cache
    feed_slots = []
    for (uid, pos, _aval) in plan.feed_keys:
        raw = w.feed_raw.get((uid, pos), _ABSENT)
        li = by_id.get(id(raw)) if raw is not _ABSENT else None
        if li is None:
            return None
        feed_slots.append(li)
    fetch_set = set(plan.fetch_keys)
    specs = []
    for t in out_leaves:
        if not isinstance(t, TerraTensor) or t._eager is not None:
            return None
        if t._iter != eng.iter_id or not isinstance(t.ref, Ref):
            return None
        try:
            key = w.uid_of(t.ref)
        except ReplayRequired:
            return None
        if key not in fetch_set:
            return None
        specs.append((key, t.aval))
    return SteadyPlan(gp=gp, sp=gp.seg_progs[0], feed_slots=tuple(feed_slots),
                      in_treedef=in_treedef, leaf_sigs=tuple(sigs),
                      avals_digest=eng.store.avals_digest(),
                      out_treedef=out_treedef, out_specs=tuple(specs),
                      last_leaves=leaves)


def observe(eng, args, kwargs, out) -> None:
    """Called after every successful walker-path iteration: advance or reset
    the family's clean-iteration streak, enter steady at the threshold."""
    fam = eng.family
    if fam is None:
        return
    threshold = getattr(eng, "steady_state", 0)
    if threshold <= 0:
        return
    plan = _build(eng, args, kwargs, out)
    if plan is None:
        fam.steady_streak = 0
        if fam.steady is not None:
            fam.steady = None
            eng.stats["steady_exits"] += 1
            ev.steady_exit(eng.events, eng.iter_id, "ineligible")
        return
    fam.steady_streak += 1
    if fam.steady is not None and fam.steady.gp is eng.gp:
        # live plan survived a probe: refresh the identity fast path
        fam.steady.last_leaves = plan.last_leaves
        return
    if fam.steady_streak >= threshold:
        plan.twin = eng.gp.steady_twin(plan.sp)
        fam.steady = plan
        eng.stats["steady_entries"] += 1
        ev.steady_enter(eng.events, eng.iter_id, fam.key)


def donates(eng, var_id: int) -> bool:
    """True when a live steady plan's twin writes ``var_id``'s buffer in
    place: a buffer read out of the store must then be copied."""
    return any(f.steady is not None and var_id in f.steady.twin.don_var_ids
               for f in eng.fm.families.values())


def attach_futures(eng, out) -> None:
    """After a walker iteration closes, pin each returned placeholder to its
    dispatcher fetch future so it stays awaitable once later iterations
    start (the scheduler's lag-harvest window; tensor.py ``_future``)."""
    if eng.mode != SKELETON or eng.walker is None or eng.dispatcher is None:
        return
    for t in tree_leaves(out):
        if (isinstance(t, TerraTensor) and t._eager is None
                and t._future is None and isinstance(t.ref, Ref)):
            try:
                fut = eng.dispatcher.future_for(t.ref)
            except ReplayRequired:
                continue
            if fut is not None:
                t._future = fut


# ---------------------------------------------------------------------------
# the zero-walker call path
# ---------------------------------------------------------------------------

def try_steady(eng, args, kwargs):
    """Dispatch this call straight from the family's SteadyPlan, or return
    :data:`MISS` to run the full walker path."""
    fam = eng.family
    plan = fam.steady if fam is not None else None
    if plan is None:
        return MISS
    if plan.gp is not eng.gp:
        # graph regenerated since capture (growth, pass-token change):
        # the cached DispatchPlan is stale — drop and re-earn the streak
        fam.steady = None
        fam.steady_streak = 0
        eng.stats["steady_exits"] += 1
        ev.steady_exit(eng.events, eng.iter_id, "gp-regenerated")
        return MISS
    probe = getattr(eng, "steady_probe", 64)
    plan.count += 1
    if probe and plan.count % probe == 0:
        ev.steady_probe(eng.events, eng.iter_id)
        return MISS                 # forced validation iteration
    try:
        leaves, treedef = tree_flatten((args, kwargs))
    except Exception:
        return MISS
    if len(leaves) != len(plan.leaf_sigs) or treedef != plan.in_treedef:
        return MISS
    if eng.store.avals_digest() != plan.avals_digest:
        return MISS                 # a variable was rebound out-of-band
    last = plan.last_leaves
    if not (last is not None and all(a is b for a, b in zip(leaves, last))):
        for leaf, sig in zip(leaves, plan.leaf_sigs):
            if sig[0] == "t":
                if isinstance(leaf, TerraTensor) or not is_tensor_like(leaf):
                    return MISS
                if tuple(leaf.shape) != sig[1] or str(leaf.dtype) != sig[2]:
                    return MISS
            else:
                # non-tensor leaves can steer Python control flow: only a
                # value-equal leaf is safe to replay against the baked plan
                try:
                    if leaf is not sig[1] and not bool(leaf == sig[1]):
                        return MISS
                except Exception:
                    return MISS
        plan.last_leaves = leaves
    return _dispatch(eng, plan, leaves)


def _dispatch(eng, plan: SteadyPlan, leaves):
    """Mirror of SegmentDispatcher.dispatch_through for one pre-validated
    segment: array fills from the DispatchPlan, fenced submit, no walker."""
    t0 = time.perf_counter()
    store, stats = eng.store, eng.stats
    buffers = store.buffers
    sp = plan.twin
    dp = sp.plan
    feeds = tuple(store.stage(leaves[li]) for li in plan.feed_slots)
    futures = {k: Future() for k in dp.fetch_keys}
    # sampled device-time attribution (DESIGN.md §15): steady iterations
    # stay eligible — the block-on-done runs on the runner thread, so the
    # imperative thread keeps its zero-walker dispatch cost; sampling
    # keeps the runner's pipelining intact on the other N-1 iterations
    pe = eng.profile_every
    profile = bool(pe and eng.events.on and (eng.iter_id + 1) % pe == 0)
    events, iter_id = eng.events, eng.iter_id + 1

    def run():
        don_in = tuple(store.read(v) for v in dp.don_var_ids)
        keep_in = tuple(store.read(v) for v in dp.keep_var_ids)
        if don_in:
            eng.steady_donated_bytes += sum(b.nbytes for b in don_in)
        if profile:
            timer = SegmentTimer(store.device)
        try:
            var_out, fetches, _ = sp.fn(don_in, keep_in, feeds,
                                        _EMPTY_I32, _EMPTY_I32, ())
        except Exception as e:          # propagate into futures
            for f in futures.values():
                if not f.done():
                    f.set_exception(e)
            raise
        if profile:
            ev.segment_profile(events, iter_id, "steady", 0, *timer.stop(),
                               dp.kernel_ops)
        for vid, v in zip(dp.var_writes, var_out):
            buffers[vid] = v
        for k, v in zip(dp.fetch_keys, fetches):
            futures[k].set_result(v)

    seq = eng.runner.submit(run, "runner.steady")
    store.fence(dp.don_var_ids, dp.var_writes, seq)
    store.fence(dp.keep_var_ids, (), seq)
    # advance the engine's iteration clock so tensors of the *previous*
    # iteration read as stale (their values arrive through ``_future``) and
    # a later walker iteration starts from a clean binding map
    eng.iter_id += 1
    eng._var_binding = {}
    stats["iterations"] += 1
    stats["steady_iters"] += 1
    stats["segments_dispatched"] += 1
    ev.segment_dispatch(eng.events, eng.iter_id, "steady", 0, seq,
                        len(plan.feed_slots))
    out_leaves = []
    for key, aval in plan.out_specs:
        t = TerraTensor(None, aval, engine=eng, iter_id=eng.iter_id)
        t._future = futures[key]
        out_leaves.append(t)
    stats["dispatch_time"] += time.perf_counter() - t0
    return tree_unflatten(plan.out_treedef, out_leaves)
