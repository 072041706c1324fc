"""Dispatchers: how validated work reaches the GraphRunner.

One :class:`Dispatcher` protocol covers the two dispatch strategies that
used to be duplicated inside the runner god-module:

* :class:`SegmentDispatcher` — the normal co-execution path: at every
  segment boundary (a top-level gating fetch, DESIGN.md §2) the
  pre-compiled ``SegProg.fn`` is submitted to the GraphRunner with its
  Input Feeding values, Case Select / Loop Cond arrays, carried values and
  variable buffers.  Donation-eligible variable buffers (computed statically
  per segment by graphgen, DESIGN.md §4.2) travel in their own argument;
  the segment writes the variable's new value into them in place, and
  ``donated_bytes`` counts them as the reference does.

* :class:`ChainDispatcher` — path-specialized dispatch for gating fetches
  that are *not* at a top-level segment boundary (e.g. inside a branch
  region): the exact linear chain of already-validated ops becomes one
  callable —
  selectors are resolved by construction, so no switch machinery is needed —
  and every produced value gets a future, replacing the old eager-replay
  fallback for structurally awkward programs.

An iteration starts with a SegmentDispatcher; the coordinator swaps in a
ChainDispatcher (which keeps a handle on its parent so segment futures stay
fetchable) the first time a mid-segment fetch gates Python.  Neither
dispatcher blocks on device readiness: results travel through futures and
the device's stream, and Python stalls only at actual fetch points.
"""

from __future__ import annotations

import time
import warnings
from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import SegmentTimer
from repro_torch.core.events import emit as ev
from repro_torch.core.trace import Ref, Trace
from repro_torch.core.executor.walker import Walker

# Case Select / Loop Cond values stay host-side numpy: a segment picks its
# branch and trip count in Python, never by reading the device
_EMPTY_I32 = np.zeros(0, np.int32)      # shared: no Case Select / Loop Cond


class Dispatcher:
    """Protocol for per-iteration dispatch strategies.

    ``kind``                   — "segments" | "chain" (coordinator branches
                                 on it at fetch points).
    ``on_boundary(seg_idx)``   — a top-level gating fetch point was walked.
    ``finish()``               — iteration validated to END: flush trailing
                                 work (side effects included).
    ``future_for(ref)``        — Future for a produced value, or None if
                                 this dispatcher will not produce it.  May
                                 raise ReplayRequired for unknown producers.
    """

    kind = "abstract"

    def on_boundary(self, seg_idx: int) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        raise NotImplementedError

    def future_for(self, ref: Ref) -> Optional[Future]:
        raise NotImplementedError


# ==========================================================================
# Segment dispatch
# ==========================================================================

class SegmentDispatcher(Dispatcher):
    kind = "segments"

    def __init__(self, gp, walker: Walker, trace: Trace, runner, store,
                 events, strict_feeds: bool = True, warn_latch=None,
                 iter_id: int = -1, profile: bool = False):
        self.gp = gp
        # sampled device-time attribution (DESIGN.md §15): decided once
        # per iteration by the coordinator; captured by run closures
        self.profile = profile
        self.walker = walker
        self.trace = trace
        self.runner = runner
        self.store = store
        self.events = events
        self.stats = events.counters
        self.iter_id = iter_id
        self.strict_feeds = strict_feeds
        # engine-lifetime warn-once latch for strict_feeds=False (a list
        # owned by the coordinator: dispatchers are per-iteration)
        self.warn_latch = warn_latch if warn_latch is not None else []
        self.fetch_futures: Dict[Tuple[int, int], Future] = {}
        self.iter_env: Dict[Tuple[int, int], Any] = {}  # runner-thread env
        self._through = -1
        # ordinal boundary a chain continuation picks up from
        self.ordinal_at_dispatch = 0

    # ------------------------------------------------------------------
    def on_boundary(self, seg_idx: int) -> None:
        self.dispatch_through(seg_idx)

    def finish(self) -> None:
        self.dispatch_through(len(self.gp.seg_progs) - 1)

    def future_for(self, ref: Ref) -> Optional[Future]:
        uid, oi = self.walker.uid_of(ref)       # ReplayRequired propagates
        return self.fetch_futures.get((uid, oi))

    # ------------------------------------------------------------------
    def dispatch_through(self, seg_idx: int) -> None:
        """Submit every not-yet-dispatched segment up to ``seg_idx`` as
        straight array fills against the precomputed DispatchPlan
        (graphgen.py, DESIGN.md §4.4) — no sorting, no per-op dict probing.
        Case Select / Loop Cond arrays are built once per call: the Walker
        cannot add entries between two segments of the same call."""
        start = self._through + 1
        if seg_idx < start:
            self.ordinal_at_dispatch = len(self.trace.entries)
            return
        t0 = time.perf_counter()
        gp, walker, store, stats = self.gp, self.walker, self.store, self.stats
        buffers, iter_env = store.buffers, self.iter_env
        feed_vals = walker.feed_vals
        plan0 = gp.seg_progs[start].plan
        sels = trips = _EMPTY_I32
        if plan0.sel_uids:
            g = walker.sels.get
            sels = np.fromiter((g(u, 0) for u in plan0.sel_uids),
                               np.int32, len(plan0.sel_uids))
        if plan0.trip_uids:
            g = walker.trips.get
            trips = np.fromiter((g(u, 0) for u in plan0.trip_uids),
                                np.int32, len(plan0.trip_uids))
        taken = None
        for si in range(start, seg_idx + 1):
            sp = gp.seg_progs[si]
            plan = sp.plan
            feeds = []
            for (uid, pos, aval) in plan.feed_keys:
                v = feed_vals.get((uid, pos))
                if v is None:
                    # zeros substitution is legitimate ONLY for feed slots
                    # of an untaken branch region; a missing feed on a node
                    # the Walker actually validated means the segment would
                    # silently compute on zeros — raise at dispatch time
                    # (warn once when the engine opted out, DESIGN.md §4.4)
                    if taken is None:          # built lazily: defaults are
                        taken = walker.taken_uids()        # the rare path
                    if uid in taken:
                        msg = (f"Input Feeding value for TraceGraph node "
                               f"{uid} arg {pos} was never collected on "
                               f"the taken path; segment {si} would "
                               f"compute on zeros")
                        if self.strict_feeds:
                            raise RuntimeError(msg)
                        if not self.warn_latch:
                            self.warn_latch.append(True)
                            warnings.warn(msg + " (strict_feeds disabled)",
                                          RuntimeWarning, stacklevel=2)
                    v = torch.zeros(aval.shape, dtype=aval.dtype,
                                    device=store.device)
                    stats["feeds_defaulted"] += 1
                feeds.append(v)
            if plan.fetch_keys:
                futures = {k: Future() for k in plan.fetch_keys}
                self.fetch_futures.update(futures)
            else:
                futures = {}

            def run(sp=sp, plan=plan, feeds=tuple(feeds), sels=sels,
                    trips=trips, futures=futures, si=si,
                    profile=self.profile):
                don_in = tuple(store.read(v) for v in plan.don_var_ids)
                keep_in = tuple(store.read(v) for v in plan.keep_var_ids)
                if don_in:
                    stats["donated_bytes"] += sum(b.nbytes for b in don_in)
                carries = tuple(iter_env[k] for k in plan.carries_in)
                if profile:
                    timer = SegmentTimer(store.device)
                try:
                    var_out, fetches, carries_out = sp.fn(
                        don_in, keep_in, feeds, sels, trips, carries)
                except Exception as e:      # propagate into futures
                    for f in futures.values():
                        if not f.done():
                            f.set_exception(e)
                    raise
                if profile:
                    # sampled device-time attribution (DESIGN.md §15):
                    # the dispatch call returns as soon as the device
                    # enqueues; blocking here — on the runner thread, off
                    # the imperative thread — exposes device time
                    ev.segment_profile(self.events, self.iter_id, "segment",
                                       si, *timer.stop(), plan.kernel_ops)
                for vid, v in zip(plan.var_writes, var_out):
                    buffers[vid] = v
                for k, v in zip(plan.carries_out, carries_out):
                    iter_env[k] = v
                for k, v in zip(plan.fetch_keys, fetches):
                    futures[k].set_result(v)

            # the fence is the submit sequence itself: even if the closure
            # raises, the runner completes the sequence, so fences release
            seq = self.runner.submit(run)
            store.fence(plan.don_var_ids, plan.var_writes, seq)
            store.fence(plan.keep_var_ids, (), seq)
            stats["segments_dispatched"] += 1
            ev.segment_dispatch(self.events, self.iter_id, "segment", si,
                                seq, len(feeds))
            self._through = si
        self.ordinal_at_dispatch = len(self.trace.entries)
        stats["dispatch_time"] += time.perf_counter() - t0



# Path-specialized chain dispatch lives in chains.py; re-exported here so
# historical import paths (and the runner.py shim) keep working.  The
# import sits at module end: chains.py imports Dispatcher/SegmentDispatcher
# from this module, which are defined by the time this line runs.
from repro_torch.core.executor.chains import ChainDispatcher  # noqa: E402,F401
