"""TerraEngine: the phase-machine coordinator of the executor package.

One engine per TerraFunction.  The engine owns the long-lived pieces — the
TraceGraph, the GraphRunner thread, the VariableStore, the cross-version
SegmentCache, the chain cache and the EventStream — and wires the
per-iteration pieces (Walker, Dispatcher, snapshot) together:

* **tracing phase** — ``record_op`` (python_runner.py) executes eagerly and
  records a Trace; ``_finish_traced_iteration`` merges it and, once
  covered, builds a GraphProgram (segments compiled through the
  SegmentCache so version bumps only recompile what changed).
* **co-execution phase** — ``record_op`` validates through the Walker and
  returns placeholder tensors; the active Dispatcher ships segments (or
  path-specialized chains) to the GraphRunner; ``materialize`` resolves
  Output Fetching against dispatcher futures.
* **divergence fallback** — delegated to fallback.DivergenceHandler; the
  engine then finishes the iteration imperatively and re-enters tracing.

All instrumentation flows through ``self.events`` (core/events/,
DESIGN.md §13): ``self.stats`` *is* the stream's counter dict, and the
structured lifecycle events (iteration open/close, divergence → rollback
→ replay chains, pass-pipeline runs) are emitted only when a structured
processor is attached.  Everything heavier than coordination lives in the
sibling modules; see DESIGN.md §3 for the package map.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.core import capture as capture_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.events import EventStream
from repro_torch.core.events import emit as ev
from repro_torch.core.graphgen import GraphProgram
from repro_torch.core.passes import observe_iteration, resolve_pipeline, run_passes
from repro_torch.core.passes.analysis import FeedObservations, FetchObservations
from repro_torch.core.persist.warmboot import open_persist
from repro_torch.core.tensor import TerraTensor, Variable
from repro_torch.core.trace import Trace
from repro_torch.core.tracegraph import TraceGraph, roll_loops
from repro_torch.core.executor.dispatch import SegmentDispatcher
from repro_torch.core.executor.fallback import DivergenceHandler
from repro_torch.core.executor.families import FamilyManager
from repro_torch.core.executor.graph_runner import GraphRunner
from repro_torch.core.executor.python_runner import PythonRunnerOps
from repro_torch.core.executor.segment_cache import SegmentCache
from repro_torch.core.executor.stats import init_stats
from repro_torch.core.executor.varapi import VariableOps
from repro_torch.core.executor.variables import VariableStore
from repro_torch.core.executor.walker import (DivergenceError, ReplayRequired,
                                        Walker)

IMPERATIVE, TRACING, SKELETON = "imperative", "tracing", "skeleton"


class TerraEngine(PythonRunnerOps, VariableOps):
    """Owns the TraceGraph, the phase state machine and the executor parts."""

    def __init__(self, lazy: bool = False, seed: int = 0,
                 min_covered: int = 1, max_families: int = 8,
                 strict_feeds: bool = True, optimize=None,
                 cache_dir: Optional[str] = None, cache_scope: str = "",
                 device=None):
        # every buffer, feed and segment of this engine lives here
        self.device = resolve_device(device)
        # the instrumentation substrate: counters + structured events
        # (benchmarks: Fig. 6 breakdown, App. F transitions); the full
        # counter registry lives in executor/stats.py
        self.events = EventStream(counters=init_stats())
        self.stats = self.events.counters
        self.tg = TraceGraph()
        self.mode = TRACING
        self.runner = GraphRunner(lazy=lazy, events=self.events)
        self.store = VariableStore(self.device)
        self.seg_cache = SegmentCache()
        self.gp: Optional[GraphProgram] = None
        self.min_covered = min_covered
        self.strict_feeds = strict_feeds
        # optimization pipeline (§10); None defers to $TERRA_OPTIMIZE
        self.pipeline = resolve_pipeline(optimize, self.device.type)
        self._feed_warned: list = []    # engine-lifetime warn-once latch
        self._covered_streak = 0
        self.skip_files: Tuple[str, ...] = ()
        self._seed = int(seed)
        self._chain_cache: Dict[Tuple, Any] = {}
        self.capture = capture_mod.context_for(self.device, self.events)
        # sampled device-time profiling cadence (DESIGN.md §15); 0 = off
        self.profile_every = 0

        self._fallback = DivergenceHandler(self.runner, self.store,
                                           self.events)
        # persistent artifact store (core/persist/, DESIGN.md §14)
        self.persist = open_persist(cache_dir, self.events, cache_scope,
                                    self)
        self.seg_cache.persist = self.persist
        self.fm = FamilyManager(max_families, self.events, self.seg_cache,
                                persist=self.persist)
        self.family = None

        # per-iteration state
        self.iter_id = -1
        self.trace: Optional[Trace] = None
        self._vals: Dict[Tuple[int, int], Any] = {}
        self._tensors: Dict[Tuple[int, int], TerraTensor] = {}
        self._feed_log: Dict[Tuple[int, int], Any] = {}
        self._var_binding: Dict[int, TerraTensor] = {}
        self._rng_count = 0
        self.walker: Optional[Walker] = None
        self.dispatcher = None
        self._iter_open = False
        self._snapshot_slot: Dict[int, Any] = {}

    @property
    def vars(self) -> Dict[int, Variable]:
        return self.store.vars

    # ------------------------------------------------------------------
    # iteration lifecycle
    # ------------------------------------------------------------------
    def start_iteration(self, feed_sig: Tuple = ()):
        # load this shape class's TraceGraph/GraphProgram/phase (§8)
        self.fm.switch(self, (feed_sig, self.store.avals_digest()))
        self.iter_id += 1
        ev.iteration_start(self.events, self.iter_id, self.mode,
                           self.family.key)
        self.trace = Trace()
        self._vals.clear()
        self._tensors = {}
        self._feed_log = {}
        self._var_binding = {}
        self._rng_count = 0
        self._iter_open = True
        self.dispatcher = None
        if self.mode == SKELETON:
            self.walker = Walker(self.gp)
            pe = self.profile_every
            self.dispatcher = SegmentDispatcher(
                self.gp, self.walker, self.trace, self.runner, self.store,
                self.events, self.strict_feeds, self._feed_warned,
                iter_id=self.iter_id,
                profile=bool(pe and self.events.on
                             and self.iter_id % pe == 0))
            snap: Dict[int, Any] = {}
            self._snapshot_slot = snap
            store = self.store
            seq = self.runner.submit(lambda: store.snapshot_into(snap),
                                     "runner.snapshot")
            # the snapshot reads every live buffer: fence it so a driver
            # rebind/release (reset_variable / release_variable) cannot
            # swap a buffer out from under the pending snapshot
            store.fence(store.buffers, (), seq)
            self.runner.open_iteration()

    def end_iteration(self):
        es = self.events
        es.inc("iterations")
        self._iter_open = False
        es.put("runner_exec_time", self.runner.exec_time)
        es.put("runner_stall_time", self.runner.stall_time)
        if self.mode == SKELETON:
            try:
                if not self.walker.at_end():
                    raise DivergenceError("iteration ended mid-TraceGraph")
                # finish() may raise ReplayRequired: a trailing chain
                # flush needed a value the optimized segments no longer
                # publish (DCE'd) — recover by eager prefix replay
                self.dispatcher.finish()
            except (DivergenceError, ReplayRequired) as e:
                self._fallback_replay(str(e) or type(e).__name__)
                self._finish_traced_iteration()
                return
            es.inc("walker_fast_hits", self.walker.fast_hits)
            ev.iteration_end(es, self.iter_id, SKELETON, False,
                             ops=len(self.trace.entries),
                             fast=self.walker.fast_hits)
            fam = self.family
            if self.walker.sels:
                # fork observation (JANUS speculation groundwork, §15);
                # fork-free iterations pay one empty-dict truthiness check
                dist = fam.sel_dist
                for fork, case in self.walker.sels.items():
                    d = dist.setdefault(fork, {})
                    d[case] = d.get(case, 0) + 1
                    ev.fork_observed(es, fam.key, fork, case)
            self.runner.close_iteration()
            if fam.hydrated:
                # first fully validated pass over a hydrated graph: the
                # warm boot is confirmed; refresh the key with the vars
                # that registered lazily during this iteration (§8/§14)
                fam.hydrated = False
                self.fm.save(self)
                self.fm.rekey(fam,
                              (fam.key[0], self.store.avals_digest()))
            return
        self._finish_traced_iteration()

    def _finish_traced_iteration(self):
        es = self.events
        es.inc("traced_iterations")
        # commit final variable bindings to the store (direct buffer access:
        # a variable commit is not a user-visible fetch point)
        for vid, t in self._var_binding.items():
            self.store.put(vid, t._eager if t._eager is not None
                           else t.value())
        rolled = roll_loops(self.trace)
        covered = self.tg.merge_trace(self.trace, rolled)
        fam = self.family
        if self.pipeline:
            # feed-stability / fetch-timing observations for the passes
            observe_iteration(self.trace, self._feed_log, self.tg,
                              fam.feed_obs, fam.fetch_obs)
        self._covered_streak = self._covered_streak + 1 if covered else 0
        if self._covered_streak >= self.min_covered:
            # pass results are cached with the GraphProgram: regenerate on
            # graph growth OR an observation change (e.g. fold unfolded)
            token = (self.pipeline, fam.feed_obs.version,
                     fam.fetch_obs.version)
            if (self.gp is None or self.gp.version != self.tg.version
                    or self.gp.opt_token != token):
                var_avals = {vid: v.aval for vid, v in self.vars.items()}
                opt = run_passes(self.tg, var_avals, self.pipeline,
                                 fam.feed_obs, fam.fetch_obs,
                                 backend=self.device.type)
                self.gp = GraphProgram(
                    self.tg, var_avals, seg_cache=self.seg_cache,
                    family_key=self.family.key, opt=opt,
                    device=self.device, capture=self.capture)
                self.gp.opt_token = token
                if opt is not None:
                    for k, v in opt.counters.items():
                        self.stats[k] += v
                    ev.pass_run(es, self.iter_id, self.family.key,
                                opt.pipeline, opt.per_pass)
                self.family.gp = self.gp
                self.fm.retain_live()   # union over ALL live families
                es.inc("graph_versions")
                es.put("segment_cache_hits", self.seg_cache.hits)
                es.put("segments_recompiled", self.seg_cache.misses)
                if self.persist is not None:
                    self.persist.save_family(self.family)
            if self.mode != SKELETON:
                es.inc("transitions")
                ev.transition(es, self.iter_id)
            self.mode = SKELETON
        else:
            self.mode = TRACING
        ev.iteration_end(es, self.iter_id, TRACING, True,
                         ops=len(self.trace.entries))
        self.fm.save(self)
        # vars register lazily during the first trace: refresh the key
        self.fm.rekey(self.family,
                      (self.family.key[0], self.store.avals_digest()))

    # ------------------------------------------------------------------
    # divergence fallback (paper: cancel GraphRunner, back to tracing)
    # ------------------------------------------------------------------
    def _fallback_replay(self, reason: str = "replay-required"):
        es = self.events
        ev.divergence(es, self.iter_id, reason)
        if self.walker is not None:
            es.inc("walker_fast_hits", self.walker.fast_hits)
            es.inc("fold_divergences", self.walker.fold_misses)
        self._fallback.cancel_and_replay(self.trace, self._feed_log,
                                         self._snapshot_slot, self._vals,
                                         self._tensors,
                                         iter_id=self.iter_id)
        self.mode = TRACING
        es.inc("retraces")
        self._covered_streak = 0
        self.walker = None
        self.dispatcher = None
        self._discard_hydrated()
        self.fm.save(self)

    def _discard_hydrated(self):
        """A hydrated family diverged before its first validated pass: the
        stored graph does not match this program, so drop the disk record
        and reset the family to an empty graph — the retrace starts clean
        ("slower never wrong") and overwrites the artifact (§14)."""
        fam = self.family
        if fam is None or not fam.hydrated:
            return
        fam.hydrated = False
        if self.persist is not None:
            self.persist.on_hydrated_divergence(fam)
        self.tg = TraceGraph(family_key=fam.key)
        self.gp = None
        fam.tg, fam.gp = self.tg, None
        fam.feed_obs = FeedObservations()
        fam.fetch_obs = FetchObservations()
        fam.steady = None
        fam.steady_streak = 0

    def abort_iteration(self):
        """Abandon an iteration after an escaping exception (a user error
        or a strict-feeds dispatch error): cancel pending symbolic work,
        roll the store back to the iteration-start snapshot, and re-enter
        tracing — the next call starts clean instead of inheriting a
        half-open iteration (stale walker, open runner window)."""
        was_skeleton = self.mode == SKELETON and self.walker is not None
        self._iter_open = False
        self.walker = None
        self.dispatcher = None
        if was_skeleton:
            es = self.events
            self.runner.cancel()
            self.store.restore(self._snapshot_slot)
            ev.rollback(es, self.iter_id, len(self._snapshot_slot))
            ev.retrace(es, self.iter_id, "abort")
            self.mode = TRACING
            es.inc("retraces")
            self._covered_streak = 0
            self._discard_hydrated()
            self.fm.save(self)

    def _recover_value(self):
        """Replay to materialize values the graph did not output.  Inside an
        open iteration this is the divergence fallback; after end_iteration
        it replays and re-commits the final variable bindings."""
        self._fallback_replay()
        if not self._iter_open:
            for vid, ref in self.trace.var_assigns.items():
                self.store.put(vid, self._vals[(ref.entry, ref.out_idx)])

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Snapshot VariableStore buffers + iteration state to a directory
        (core/persist/checkpoint.py); a fresh process restores with
        :meth:`restore_checkpoint` and continues where this one stopped."""
        from repro_torch.core.persist import save_engine
        save_engine(self, path)

    def restore_checkpoint(self, path: str) -> None:
        from repro_torch.core.persist import restore_engine
        restore_engine(self, path)

    # ------------------------------------------------------------------
    def sync(self):
        """Drain dispatch AND block until device work has completed — the
        one remaining full barrier (per-value fences cover everything
        else, DESIGN.md §4.4).  Deferred async device errors surface here
        (the per-segment barrier is gone, so this is the first guaranteed
        sync point)."""
        self.runner.drain()
        es = self.events
        es.put("runner_exec_time", self.runner.exec_time)
        es.put("runner_stall_time", self.runner.stall_time)
        es.put("segment_cache_hits", self.seg_cache.hits)
        es.put("segments_recompiled", self.seg_cache.misses)
        err = self.runner.take_error()
        if err is not None:                 # fetchless closure failure
            raise err
        self.store.synchronize()

    def close(self):
        self.runner.drain()
        self.runner.stop()
        self.events.close()
        capture_mod.release(self.capture)
