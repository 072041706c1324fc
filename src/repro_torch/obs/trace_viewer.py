"""Chrome/Perfetto trace-event export of the co-execution timeline (§15).

``chrome_trace(events)`` renders a list of typed events (live objects or
``schema.load_jsonl`` output) as trace-event JSON — the format both
``chrome://tracing`` and https://ui.perfetto.dev load directly.  Track
layout makes the paper's overlap claim *visible*:

* process 1 ``terra-engine`` — one lane per runtime actor: the
  imperative Python thread (iteration spans), walker validation
  (divergence → rollback → replay instants, linked by flow arrows),
  GraphRunner execution (per-seq closure spans, from RunnerComplete),
  device execution (sampled SegmentProfile spans, host-dispatch split in
  ``args``), and the serving scheduler's step loop.
* process 2 ``requests`` — one lane per request id; the admit → retire
  span with per-token instants, and flow arrows chaining
  submit → admit → prefill → first token → retire.

:class:`TraceViewerExporter` is the live-processor wrapper: one list
append per event (the same discipline as ``JsonlSink``; this is what the
bench's ≥0.98× profiling-overhead gate measures), rendering deferred to
``export()``/``close()``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.core.events import types as T
from repro_torch.core.events.processors import Processor

PID_ENGINE, PID_REQ = 1, 2
TID_PY, TID_WALKER, TID_RUNNER, TID_DEVICE, TID_SCHED = 1, 2, 3, 4, 5
_TID_NAMES = {TID_PY: "python (imperative)", TID_WALKER: "walker",
              TID_RUNNER: "graph-runner", TID_DEVICE: "device (sampled)",
              TID_SCHED: "scheduler"}


def _meta(pid: int, tid: int, name: str, what: str = "thread_name") -> Dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def _x(name, pid, tid, ts, dur, args=None) -> Dict:
    e = {"ph": "X", "name": name, "pid": pid, "tid": tid,
         "ts": ts, "dur": max(dur, 0.0), "cat": "terra"}
    if args:
        e["args"] = args
    return e


def _i(name, pid, tid, ts, args=None) -> Dict:
    e = {"ph": "i", "name": name, "pid": pid, "tid": tid, "ts": ts,
         "s": "t", "cat": "terra"}
    if args:
        e["args"] = args
    return e


def _flow(ph, fid, name, pid, tid, ts) -> Dict:
    e = {"ph": ph, "id": fid, "name": name, "cat": "flow",
         "pid": pid, "tid": tid, "ts": ts}
    if ph == "f":
        e["bp"] = "e"               # bind to the enclosing slice
    return e


def chrome_trace(events: List[Any]) -> Dict[str, Any]:
    """Build the trace-event JSON dict for a list of typed events."""
    stamped = [e for e in events if e.ts is not None]
    t0 = min((e.ts for e in stamped), default=0.0)

    def us(ts: float) -> float:
        return (ts - t0) * 1e6

    out: List[Dict] = [_meta(PID_ENGINE, 0, "terra-engine", "process_name"),
                       _meta(PID_REQ, 0, "requests", "process_name")]
    out.extend(_meta(PID_ENGINE, tid, name)
               for tid, name in _TID_NAMES.items())

    iter_open: Dict[int, Any] = {}        # iter_id -> IterationStart
    req_admit: Dict[int, Any] = {}        # rid -> RequestAdmit
    seen_rids: List[int] = []
    for e in stamped:
        ts = us(e.ts)
        k = type(e)
        if k is T.IterationStart:
            iter_open[e.iter_id] = e
        elif k is T.IterationEnd:
            s = iter_open.pop(e.iter_id, None)
            if s is not None:
                out.append(_x(f"iter {e.iter_id} [{e.mode}]", PID_ENGINE,
                              TID_PY, us(s.ts), ts - us(s.ts),
                              {"ops_validated": e.ops_validated,
                               "fast_hits": e.fast_hits,
                               "family": s.family}))
        elif k is T.SegmentDispatch:
            out.append(_i(f"dispatch {e.kind}[{e.index}]", PID_ENGINE,
                          TID_PY, ts, {"seq": e.seq, "iter": e.iter_id,
                                       "feeds": e.feeds}))
        elif k is T.RunnerComplete:
            out.append(_x(f"seq {e.seq}", PID_ENGINE, TID_RUNNER,
                          ts - e.wall * 1e6, e.wall * 1e6,
                          {"stall_us": round(e.stall * 1e6, 1)}))
        elif k is T.SegmentProfile:
            out.append(_x(f"{e.kind}[{e.index}] device", PID_ENGINE,
                          TID_DEVICE, ts - e.device * 1e6, e.device * 1e6,
                          {"iter": e.iter_id,
                           "dispatch_us": round(e.dispatch * 1e6, 1),
                           "kernels": list(e.kernels)}))
        elif k is T.Divergence:
            fid = f"div:{e.iter_id}"
            out.append(_i(f"divergence {e.iter_id}", PID_ENGINE, TID_WALKER,
                          ts, {"reason": e.reason}))
            out.append(_flow("s", fid, "recovery", PID_ENGINE, TID_WALKER,
                             ts))
        elif k is T.Rollback:
            out.append(_i(f"rollback {e.iter_id}", PID_ENGINE, TID_WALKER,
                          ts, {"vars_restored": e.vars_restored}))
            out.append(_flow("t", f"div:{e.iter_id}", "recovery",
                             PID_ENGINE, TID_WALKER, ts))
        elif k is T.Replay:
            out.append(_i(f"replay {e.iter_id}", PID_ENGINE, TID_WALKER,
                          ts, {"entries": e.entries}))
            out.append(_flow("f", f"div:{e.iter_id}", "recovery",
                             PID_ENGINE, TID_WALKER, ts))
        elif k in (T.SteadyEnter, T.SteadyExit, T.SteadyProbe,
                   T.SteadyPoison, T.Transition, T.FamilySwitch,
                   T.ForkObserved):
            out.append(_i(k.__name__, PID_ENGINE, TID_WALKER, ts))
        elif k is T.StepDispatch:
            out.append(_x(f"{e.kind} step", PID_ENGINE, TID_SCHED,
                          ts - e.dur * 1e6, e.dur * 1e6,
                          {"rows": e.rows, "queue_depth": e.queue_depth,
                           "resident": e.resident}))
        elif k is T.StepHarvest:
            out.append(_x(f"{e.kind} harvest", PID_ENGINE, TID_SCHED,
                          ts - e.wait * 1e6, e.wait * 1e6))
        elif k is T.SchedulerIdle:
            out.append(_x("idle", PID_ENGINE, TID_SCHED, ts,
                          e.wait * 1e6))
        elif k is T.RequestSubmit:
            seen_rids.append(e.rid)
            out.append(_i(f"submit r{e.rid}", PID_ENGINE, TID_SCHED, ts,
                          {"prompt_len": e.prompt_len,
                           "max_new": e.max_new}))
            out.append(_flow("s", f"req:{e.rid}", "lifecycle",
                             PID_ENGINE, TID_SCHED, ts))
        elif k is T.RequestAdmit:
            req_admit[e.rid] = e
            out.append(_i(f"admit r{e.rid}", PID_REQ, e.rid, ts,
                          {"slot": e.slot,
                           "queued_ms": round(e.queued_s * 1e3, 3)}))
            out.append(_flow("t", f"req:{e.rid}", "lifecycle",
                             PID_REQ, e.rid, ts))
        elif k is T.RequestPrefill:
            out.append(_i(f"prefill r{e.rid}", PID_REQ, e.rid, ts,
                          {"bucket": e.bucket, "prompt_len": e.prompt_len}))
            out.append(_flow("t", f"req:{e.rid}", "lifecycle",
                             PID_REQ, e.rid, ts))
        elif k is T.RequestToken:
            out.append(_i(f"token[{e.index}]", PID_REQ, e.rid, ts))
            if e.index == 0:
                out.append(_flow("t", f"req:{e.rid}", "lifecycle",
                                 PID_REQ, e.rid, ts))
        elif k is T.RequestRetire:
            a = req_admit.pop(e.rid, None)
            if a is not None:
                out.append(_x(f"r{e.rid} [{e.reason}]", PID_REQ, e.rid,
                              us(a.ts), ts - us(a.ts),
                              {"tokens": e.tokens}))
            out.append(_flow("f", f"req:{e.rid}", "lifecycle",
                             PID_REQ, e.rid, ts))
    out.extend(_meta(PID_REQ, rid, f"request {rid}")
               for rid in dict.fromkeys(seen_rids))
    out.sort(key=lambda d: (d.get("ts", -1.0), d["pid"], d["tid"]))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


class TraceViewerExporter(Processor):
    """Live event processor buffering the stream for timeline export.

    Per-event cost is one list append; rendering happens in ``export()``
    (or ``close()`` when a path was given), never on the emit path.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: List[Any] = []

    def process(self, event) -> None:
        self.events.append(event)

    def trace(self) -> Dict[str, Any]:
        return chrome_trace(self.events)

    def export(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("no export path given")
        with open(path, "w") as f:
            json.dump(self.trace(), f)
        return path

    def close(self) -> None:
        if self.path is not None and self.events:
            self.export()
