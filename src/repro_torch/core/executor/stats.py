"""Engine counter registry: every stat the TerraEngine exports, in one
place so the coordinator stays a phase machine and the benchmarks
(fig6_breakdown, bench_hotpath) have a single source of truth for what
exists.  Groups follow the perf layers they instrument (DESIGN.md §4, §8,
§10)."""

from __future__ import annotations

from typing import Any, Dict


def init_stats() -> Dict[str, Any]:
    return {
        # paper Fig. 6 breakdown / App. F transitions
        "iterations": 0, "traced_iterations": 0, "transitions": 0,
        "replays": 0, "replayed_entries": 0, "py_stall_time": 0.0,
        "graph_versions": 0, "segments_dispatched": 0,
        "segments_recompiled": 0, "segment_cache_hits": 0,
        "donated_bytes": 0,
        # hot-path counters (DESIGN.md §4.4, benchmarks/bench_hotpath)
        "dispatch_time": 0.0,       # Python-thread time in dispatch
        "feeds_defaulted": 0,       # zeros substituted for missing feeds
        "walker_fast_hits": 0,      # ops validated via the stamp path
        # zero-walker steady state (DESIGN.md §12)
        "steady_iters": 0,          # iterations dispatched without a walker
        "steady_entries": 0,        # steady plans built (entries into mode)
        "steady_exits": 0,          # plans dropped (divergence/rebuild)
        # (the bytes a steady twin donates are the engine's
        # ``steady_donated_bytes``: this dict stays the reference's)
        # GraphRunner occupancy, mirrored from the runner thread
        "runner_exec_time": 0.0, "runner_stall_time": 0.0,
        # shape-keyed TraceGraph families (DESIGN.md §8)
        "retraces": 0,          # tracing entered: new shape / divergence
        "family_switches": 0,   # flips to an already-traced shape class
        "families_evicted": 0, "families": 0,
        # symbolic optimization pipeline (core/passes/, DESIGN.md §10)
        "nodes_eliminated": 0,      # DCE: ops skipped at compile time
        "cse_hits": 0,              # duplicate subexpressions merged
        "feeds_folded": 0,          # Input Feeds demoted to constants
        "segments_coalesced": 0,    # gating boundaries removed
        "kernels_substituted": 0,   # subgraphs fused to kernel ops
        "fold_divergences": 0,      # folded feed changed → re-trace
        # persistent artifact store / warm boot (core/persist/, §14)
        "artifact_hits": 0,         # records/executables loaded from disk
        "artifact_misses": 0,       # consults that fell through
        "artifacts_stored": 0,      # records/executables written
        "warm_families": 0,         # families hydrated instead of traced
        "aot_loads": 0,             # segments deserialized (no recompile)
        "checkpoint_saves": 0, "checkpoint_restores": 0,
    }
