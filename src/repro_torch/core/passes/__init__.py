"""Symbolic optimization pass pipeline over the decoupled graph.

Terra's decoupling argument (paper §3) is that once DL ops are separated
from Python features, the symbolic side can deliver "the optimized
performance of symbolic graph execution".  This package is that promise
made concrete (DESIGN.md §10): a pipeline of semantics-preserving
rewrites that runs **once per shape family**, between trace completion
and segment compilation, over a rewrite-safe *clone* of the TraceGraph —
the Walker keeps validating against the original graph, so divergence
detection, rollback and walker stamps are untouched.

Passes (canonical order):

    fold      constant-feed folding: Input Feeds observed identical across
              the covered streak demote to baked constants; a later value
              mismatch diverges back to a feed (walker probe)
    cse       common-subexpression elimination keyed on TGNode.sig()
              minus program location, including hoisting duplicates out
              of sibling switch branches
    kernels   pattern-match traced subgraphs (rms_norm, softmax
              attention, paged decode) into the kernel ops of
              repro_torch/kernels/
    dce       dead-op elimination for nodes whose outputs are never
              fetched, variable-written or loop-carried
    coalesce  segment coalescing: drop gating boundaries whose fetch
              values Python provably reads late (fetch-timing
              observations), plus the empty trailing segment

``optimize="none"`` short-circuits to no pipeline: the GraphProgram then
compiles the original graph exactly as before, bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Set, Tuple

from repro_torch.core.passes.analysis import (FeedObservations, FetchObservations,
                                        FoldedConst, observe_iteration)

Key = Tuple[int, int]

PASS_ORDER = ("fold", "cse", "kernels", "dce", "coalesce")

PIPELINES = {
    "none": (),
    # "safe": everything that never bakes a Python value into the graph —
    # serving uses this so per-call feeds (decode tokens) are never folded
    "safe": ("cse", "dce", "coalesce"),
    "all": ("fold", "cse", "dce", "coalesce"),
}


def resolve_pipeline(optimize, backend: str = "cpu") -> Tuple[str, ...]:
    """Normalize the ``optimize=`` knob to a canonical pass tuple.

    ``None`` defers to ``TERRA_OPTIMIZE`` (default ``all``).  ``"all"``
    additionally enables kernel substitution on the ``"cuda"`` backend
    (the engine's device type), where the hand-written kernels run;
    elsewhere ``kernels`` must be requested explicitly (the plain versions
    the wrappers run on the CPU are for validation, not speed).  An
    explicit tuple/list is validated and reordered."""
    if optimize is None:
        optimize = os.environ.get("TERRA_OPTIMIZE") or "all"
    if isinstance(optimize, str):
        if optimize not in PIPELINES:
            raise ValueError(f"unknown optimize level {optimize!r}; "
                             f"expected one of {sorted(PIPELINES)} or a "
                             f"tuple of pass names {PASS_ORDER}")
        passes = set(PIPELINES[optimize])
        if optimize == "all" and backend == "cuda":
            passes.add("kernels")
    else:
        passes = set(optimize)
        unknown = passes - set(PASS_ORDER)
        if unknown:
            raise ValueError(f"unknown pass names {sorted(unknown)}")
    return tuple(p for p in PASS_ORDER if p in passes)


@dataclasses.dataclass
class OptResult:
    """Pipeline output consumed by GraphProgram: the optimized graph plus
    the execution-time annotations graphgen honors (skip dead nodes, bind
    alias outputs from their representative, unwrap folded constants) and
    the walker-side fold probes.  Cached on the GraphProgram (per family)
    and rebuilt whenever the graph version or the observations change."""
    otg: Any                                     # rewritten TraceGraph clone
    pipeline: Tuple[str, ...] = ()
    dead: Set[int] = dataclasses.field(default_factory=set)
    alias_nodes: Dict[int, Tuple[Key, ...]] = dataclasses.field(
        default_factory=dict)
    folded: Dict[Key, FoldedConst] = dataclasses.field(default_factory=dict)
    # kernel substitution can move a feed source onto a new consumer node;
    # the Walker still collects the value under the ORIGINAL (uid, pos),
    # so graphgen emits dispatch feed keys through this map:
    # (new_uid, new_pos) -> (orig_uid, orig_pos)
    feed_moved: Dict[Key, Key] = dataclasses.field(default_factory=dict)
    drop_empty_trailing: bool = False
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per-pass counter deltas, in pipeline order: pass name -> the subset
    # of ``counters`` that pass changed (the PassPipelineRun event payload)
    per_pass: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def eff_srcs(self, n) -> Tuple:
        """Effective dataflow sources of a node after rewriting: dead
        nodes consume nothing, alias nodes consume their representative's
        outputs, everything else its (possibly rewritten) srcs."""
        if n.uid in self.dead:
            return ()
        al = self.alias_nodes.get(n.uid)
        if al is not None:
            return tuple(("node", u, oi) for (u, oi) in al)
        return n.srcs

    def bump(self, counter: str, by: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + by


class PassContext:
    """Mutable state threaded through one pipeline run."""

    def __init__(self, otg, opt: OptResult, var_avals,
                 feed_obs: FeedObservations, fetch_obs: FetchObservations,
                 backend: str = "cpu"):
        self.otg = otg
        self.backend = backend      # the engine's device type
        self.opt = opt
        self.var_avals = var_avals
        self.feed_obs = feed_obs
        self.fetch_obs = fetch_obs
        self._structure = None

    @property
    def structure(self):
        if self._structure is None:
            from repro_torch.core.casing import Structure
            self._structure = Structure(self.otg)
        return self._structure

    def invalidate_structure(self) -> None:
        self._structure = None


def run_passes(tg, var_avals, pipeline: Sequence[str],
               feed_obs: FeedObservations,
               fetch_obs: FetchObservations,
               backend: str = "cpu") -> Optional[OptResult]:
    """Run ``pipeline`` over a rewrite clone of ``tg``; None when empty."""
    if not pipeline:
        return None
    from repro_torch.core.passes import coalesce, cse, dce, feed_fold, kernel_sub
    runners = {"fold": feed_fold.run, "cse": cse.run,
               "kernels": kernel_sub.run, "dce": dce.run,
               "coalesce": coalesce.run}
    otg = tg.clone_for_rewrite()
    opt = OptResult(otg=otg, pipeline=tuple(pipeline))
    ctx = PassContext(otg, opt, var_avals, feed_obs, fetch_obs, backend)
    for name in PASS_ORDER:
        if name in pipeline:
            before = dict(opt.counters)
            runners[name](ctx)
            delta = {k: v - before.get(k, 0)
                     for k, v in opt.counters.items()
                     if v != before.get(k, 0)}
            opt.per_pass[name] = delta
    return opt


__all__ = ["FeedObservations", "FetchObservations", "FoldedConst",
           "OptResult", "PassContext", "observe_iteration", "PASS_ORDER",
           "PIPELINES", "resolve_pipeline", "run_passes"]
