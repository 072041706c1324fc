"""Shape-keyed TraceGraph families (DESIGN.md §8).

One TraceGraph can only describe one shape class: every op node records the
concrete out avals of the trace that created it, so a batch-size or
sequence-bucket change used to be indistinguishable from real control-flow
divergence — the engine cancelled the iteration, re-traced, and threw away
every compiled segment.  JANUS-style profile specialization applied to
shapes fixes this: the engine keys TraceGraphs (with their GraphPrograms
and walker state) by a **shape-class signature** of the iteration, keeps a
bounded LRU of live families, and switches between them at iteration start
with a dictionary lookup.  Each shape class traces and compiles exactly
once; flipping back to a previously seen shape is zero retraces and zero
recompiles.

The signature has two parts, combined into the family key at
``TerraEngine.start_iteration``:

* the **feed part** — (shape, dtype) of every tensor-like leaf of the
  call arguments (computed by ``feed_signature``, called from
  ``TerraFunction.__call__``), and
* the **variable part** — a digest of (var_id, aval) over every variable
  registered in the store (``VariableStore.avals_digest``), so an
  out-of-band rebind to a different shape (serving: KV cache after a
  prefill of a new batch size) selects the right sibling graph.

Variables are registered lazily during the first traced iteration, so a
family's key is **re-keyed** after every traced iteration with the then-
current variable digest; the feed part is fixed at iteration start.

Eviction: families are LRU-ordered by activation; creating one past
``max_families`` evicts the least recently used non-active family and
drops its compiled segments from the shared SegmentCache — except those
whose structural signatures are also reachable from a surviving family
(cross-family sharing, segment_cache.py).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Tuple

from repro_torch.core.events import emit as ev
from repro_torch.core.passes.analysis import FeedObservations, FetchObservations
from repro_torch.core.pytree import tree_leaves
from repro_torch.core.tensor import TerraTensor
from repro_torch.core.trace import is_tensor_like
from repro_torch.core.tracegraph import TraceGraph

TRACING = "tracing"


def feed_signature(args, kwargs) -> Tuple:
    """Shape-class signature of one call's arguments: (shape, dtype) of
    every tensor-like leaf, in tree order.  Non-tensor leaves (Python
    scalars, None, config objects) are control-flow inputs, not shape
    inputs — a change in them either validates against the same graph or
    diverges into a sibling branch of the same family."""
    out = []
    for leaf in tree_leaves((args, kwargs)):
        if isinstance(leaf, TerraTensor) or is_tensor_like(leaf):
            out.append((tuple(leaf.shape), str(leaf.dtype)))
    return tuple(out)


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Round ``n`` up to the next power-of-two cell (DESIGN.md §5/§8): the
    optional bucketing policy drivers apply to batch/sequence sizes before
    they reach the engine, bounding family cardinality to O(log n)."""
    cell = max(1, floor)
    while cell < n:
        cell <<= 1
    return cell


@dataclasses.dataclass
class TraceFamily:
    """Per-shape-class engine state: the TraceGraph, its compiled program,
    the phase-machine fields the coordinator swaps at iteration start, and
    the observation records the optimization passes consume (DESIGN.md
    §10) — per family, because feed stability and fetch timing are
    properties of one shape class's traces."""
    key: Tuple
    tg: TraceGraph
    gp: Any = None                  # GraphProgram, once covered
    mode: str = TRACING
    covered_streak: int = 0
    feed_obs: FeedObservations = dataclasses.field(
        default_factory=FeedObservations)
    fetch_obs: FetchObservations = dataclasses.field(
        default_factory=FetchObservations)
    # zero-walker steady state (executor/steady.py, DESIGN.md §12)
    steady: Any = None              # SteadyPlan, once eligible
    steady_streak: int = 0          # consecutive clean eligible iterations
    # warm boot (core/persist/, DESIGN.md §14): True between hydration
    # from the artifact store and the first fully validated iteration
    hydrated: bool = False
    _persist_rec: Any = None        # relpath of the on-disk record
    # fork observation (DESIGN.md §15, JANUS speculation groundwork):
    # {fork uid: {case index: count}} over validated skeleton iterations
    sel_dist: dict = dataclasses.field(default_factory=dict)


class FamilyManager:
    """Owns the key -> TraceFamily LRU and the shared-cache retention set."""

    def __init__(self, max_families: int, events, seg_cache, persist=None):
        self.max_families = max(1, int(max_families))
        self.events = events
        self.stats = events.counters
        self.seg_cache = seg_cache
        self.persist = persist
        self.families: "OrderedDict[Tuple, TraceFamily]" = OrderedDict()

    def __len__(self) -> int:
        return len(self.families)

    # ------------------------------------------------------------------
    # coordinator surface: swap the engine's phase state per shape class
    # ------------------------------------------------------------------
    def save(self, engine) -> None:
        """Write the engine's live phase state back into its family."""
        fam = engine.family
        fam.tg, fam.gp, fam.mode = engine.tg, engine.gp, engine.mode
        fam.covered_streak = engine._covered_streak

    def switch(self, engine, key: Tuple) -> None:
        """Iteration-start family selection: adopt the engine's boot state
        as the first family, stay put on a key match, or save the active
        family and load (or create) the sibling for ``key``.  A new shape
        class must trace (counted as a retrace); flipping back to a known
        one is a dictionary lookup — no retrace, no recompile."""
        fam = engine.family
        if fam is None:
            if self.persist is not None:
                fam = self.persist.hydrate_family(key, engine)
            if fam is None:
                engine.tg.family_key = key
                fam = TraceFamily(key, engine.tg, engine.gp, engine.mode,
                                  engine._covered_streak)
            self.families[key] = fam
            engine.family = fam
            engine.tg, engine.gp, engine.mode = fam.tg, fam.gp, fam.mode
            engine._covered_streak = fam.covered_streak
        elif key != fam.key:
            self.save(engine)
            fam, created = self.activate(key, engine)
            self.stats["retraces" if created else "family_switches"] += 1
            ev.family_switch(self.events, key, created)
            engine.family = fam
            engine.tg, engine.gp, engine.mode = fam.tg, fam.gp, fam.mode
            engine._covered_streak = fam.covered_streak
        self.stats["families"] = len(self.families)

    def activate(self, key: Tuple, engine=None) -> Tuple[TraceFamily, bool]:
        """Look up (LRU-touch) or create the family for ``key``; returns
        (family, created).  A miss consults the artifact store first (an
        evicted-then-reactivated family warm-boots from disk instead of
        retracing).  Creation past the cap evicts the least recently used
        other family — notifying the persist layer, which saves its graph
        so the eviction is reversible — and drops its compiled segments
        from the shared cache (minus any shared with a surviving
        family)."""
        fam = self.families.get(key)
        if fam is not None:
            self.families.move_to_end(key)
            return fam, False
        if self.persist is not None and engine is not None:
            fam = self.persist.hydrate_family(key, engine)
        created = fam is None
        if fam is None:
            fam = TraceFamily(key, TraceGraph(family_key=key))
        self.families[key] = fam
        while len(self.families) > self.max_families:
            vkey = next(k for k, f in self.families.items()
                        if f is not fam)
            victim = self.families.pop(vkey)
            self.stats["families_evicted"] += 1
            if self.persist is not None:
                self.persist.on_family_evicted(victim)
            self.retain_live()
        return fam, created

    def rekey(self, fam: TraceFamily, new_key: Tuple) -> None:
        """Move a family to the key observed at the end of a traced
        iteration (variables register lazily during the first trace).  A
        collision with an existing family keeps both as-is — the
        provisional key simply goes cold and ages out of the LRU."""
        if new_key == fam.key or new_key in self.families:
            return
        del self.families[fam.key]
        fam.key = new_key
        fam.tg.family_key = new_key
        self.families[new_key] = fam

    # ------------------------------------------------------------------
    def live_signatures(self) -> set:
        """Union of compiled-segment signatures over every live family —
        the SegmentCache retention set.  Per-family retention (the pre-
        family behaviour) would evict sibling families' callables on every
        regeneration and destroy exactly the reuse families exist for."""
        keys = set()
        for fam in self.families.values():
            if fam.gp is not None:
                keys.update(sp.signature for sp in fam.gp.seg_progs)
        return keys

    def retain_live(self) -> None:
        self.seg_cache.retain(self.live_signatures())
