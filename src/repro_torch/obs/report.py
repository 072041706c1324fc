"""Offline trace analysis CLI (DESIGN.md §15).

``python -m repro_torch.obs.report trace.jsonl`` loads a JSONL event stream
(the ``JsonlSink`` artifact the benches export), validates it against the
schema, and prints:

* the per-segment host/device time table — ``SegmentDispatch`` joined to
  ``RunnerComplete`` on ``seq`` (host closure wall) and to the sampled
  ``SegmentProfile`` events on ``(iter_id, kind, index)`` (dispatch vs
  device split, per-kernel attribution),
* the divergence → rollback → replay audit,
* per-family fork selector distributions (``ForkObserved``),
* the serving metrics snapshot (the same ``MetricsRegistry`` the live
  scheduler uses, replayed over the stream),

and writes the Chrome/Perfetto export next to the input
(``<input>.trace.json`` unless ``--out`` says otherwise).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from repro_torch.core.events import types as T
from repro_torch.core.events.schema import load_jsonl
from repro_torch.obs.metrics import MetricsProcessor, counters_table
from repro_torch.obs.trace_viewer import chrome_trace


def _fmt_us(s: float) -> str:
    return f"{s * 1e6:10.1f}"


def segment_table(events: List[Any]) -> str:
    """Aggregate per-(kind, index) segment rows: dispatch count, mean host
    closure wall (all iterations, via RunnerComplete), and — where sampled
    — mean host-dispatch and device time from SegmentProfile."""
    complete = {e.seq: e for e in events if type(e) is T.RunnerComplete}
    rows: Dict[tuple, Dict[str, Any]] = {}
    for e in events:
        if type(e) is T.SegmentDispatch:
            r = rows.setdefault((e.kind, e.index),
                                {"n": 0, "wall": 0.0, "walls": 0,
                                 "disp": 0.0, "dev": 0.0, "prof": 0,
                                 "kernels": ()})
            r["n"] += 1
            c = complete.get(e.seq)
            if c is not None:
                r["wall"] += c.wall
                r["walls"] += 1
        elif type(e) is T.SegmentProfile:
            r = rows.setdefault((e.kind, e.index),
                                {"n": 0, "wall": 0.0, "walls": 0,
                                 "disp": 0.0, "dev": 0.0, "prof": 0,
                                 "kernels": ()})
            r["disp"] += e.dispatch
            r["dev"] += e.device
            r["prof"] += 1
            if e.kernels:
                r["kernels"] = tuple(e.kernels)
    if not rows:
        return "(no segment dispatches in trace)"
    lines = [f"{'segment':<14}{'count':>7}{'host µs':>11}{'disp µs':>11}"
             f"{'device µs':>11}{'sampled':>9}  kernels"]
    for (kind, idx), r in sorted(rows.items()):
        wall = _fmt_us(r["wall"] / r["walls"]) if r["walls"] else " " * 10
        disp = _fmt_us(r["disp"] / r["prof"]) if r["prof"] else " " * 10
        dev = _fmt_us(r["dev"] / r["prof"]) if r["prof"] else " " * 10
        lines.append(f"{kind + '[' + str(idx) + ']':<14}{r['n']:>7}"
                     f"{wall:>11}{disp:>11}{dev:>11}{r['prof']:>9}  "
                     f"{','.join(r['kernels']) or '-'}")
    return "\n".join(lines)


def divergence_audit(events: List[Any]) -> str:
    """The recovery chains: every Divergence with its Rollback/Replay/
    Retrace events (joined on iter_id), plus steady-state transitions."""
    by_iter: Dict[int, List[str]] = {}
    for e in events:
        k = type(e)
        if k is T.Divergence:
            by_iter.setdefault(e.iter_id, []).append(
                f"divergence ({e.reason})")
        elif k is T.Rollback:
            by_iter.setdefault(e.iter_id, []).append(
                f"rollback ({e.vars_restored} vars)")
        elif k is T.Replay:
            by_iter.setdefault(e.iter_id, []).append(
                f"replay ({e.entries} entries)")
        elif k is T.Retrace:
            by_iter.setdefault(e.iter_id, []).append(
                f"retrace ({e.reason or 'trace'})")
    steady = sum(1 for e in events if type(e) is T.SteadyEnter)
    exits = sum(1 for e in events if type(e) is T.SteadyExit)
    probes = sum(1 for e in events if type(e) is T.SteadyProbe)
    lines = []
    if not by_iter:
        lines.append("  no divergences")
    for iter_id in sorted(by_iter):
        lines.append(f"  iter {iter_id}: " + " -> ".join(by_iter[iter_id]))
    lines.append(f"  steady-state: {steady} entries, {exits} exits, "
                 f"{probes} probes")
    return "\n".join(lines)


def fork_distribution(events: List[Any]) -> str:
    """Per-family selector distributions from ForkObserved events."""
    dist: Dict[tuple, Dict[int, int]] = {}
    for e in events:
        if type(e) is T.ForkObserved:
            d = dist.setdefault((e.family, e.fork), {})
            d[e.case] = d.get(e.case, 0) + 1
    if not dist:
        return "  no fork observations"
    lines = []
    for (fam, fork), cases in sorted(dist.items()):
        total = sum(cases.values())
        shares = ", ".join(f"case {c}: {n} ({n / total:.0%})"
                           for c, n in sorted(cases.items()))
        lines.append(f"  family {fam} fork {fork}: {shares}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Analyze a Terra event-stream JSONL trace and export "
                    "a Chrome/Perfetto timeline.")
    p.add_argument("trace", help="trace.jsonl written by JsonlSink")
    p.add_argument("--out", default=None,
                   help="Perfetto JSON path (default: <trace>.trace.json)")
    p.add_argument("--no-metrics", action="store_true",
                   help="skip the metrics snapshot section")
    args = p.parse_args(argv)

    events = load_jsonl(args.trace)
    print(f"{args.trace}: {len(events)} events, "
          f"{len({type(e).__name__ for e in events})} types")

    print("\n== per-segment host/device time ==")
    print(segment_table(events))
    print("\n== divergence/replay audit ==")
    print(divergence_audit(events))
    print("\n== fork selector distribution ==")
    print(fork_distribution(events))

    if not args.no_metrics:
        mp = MetricsProcessor()
        for e in events:
            mp.process(e)
        snap = mp.registry.snapshot()
        if snap["histograms"]:
            print("\n== serving metrics ==")
            for name, h in snap["histograms"].items():
                print(f"  {name}: n={h['count']} mean={h['mean']:.3f} "
                      f"p50={h['p50']:.3f} p95={h['p95']:.3f} "
                      f"p99={h['p99']:.3f}")
        if snap["gauges"]:
            print(counters_table(snap["gauges"]))

    out = args.out or (args.trace + ".trace.json")
    trace = chrome_trace(events)
    with open(out, "w") as f:
        json.dump(trace, f)
    print(f"\nwrote {out} ({len(trace['traceEvents'])} trace events) — "
          f"load in ui.perfetto.dev or chrome://tracing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
