"""Pluggable event processors (DESIGN.md §13).

A processor is anything with ``process(event)`` / ``close()``.  Processors
compose: attach any number to one :class:`EventStream`; each sees every
structured event in emission order (emission is serialized by the stream).
The contract is deliberately small so drivers and benchmarks can bring
their own — the four below cover the repo's needs:

* :class:`CountersProcessor` — the always-on flat counter dict; the
  stream's ``inc``/``add`` fast path writes into it directly, so its
  ``data`` dict reproduces the pre-event-layer ``engine.stats`` /
  scheduler counters bit for bit.
* :class:`TimingProcessor` — per-step and per-segment host-time breakdown
  (dispatch / fetch-wait / runner occupancy), replacing the benchmarks'
  private accumulators.
* :class:`RequestTraceProcessor` — one JSON-serializable causal trace per
  serving request (submit → admit → prefill → tokens → retire).
* :class:`JsonlSink` — buffered JSONL export of the full stream; the
  artifact the schema validator (schema.py) checks in CI.
* :class:`ListProcessor` — in-memory capture, for tests and ad-hoc
  debugging.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.core.events import types as T


class Processor:
    """Structured-event consumer contract."""

    def process(self, event) -> None:      # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class CountersProcessor(Processor):
    """Owns the flat counter dict the stream's fast path writes into.

    It deliberately ignores structured events: counters are updated
    through ``EventStream.inc``/``add``/``put`` so the disabled-tracing
    path stays one dict op — this class exists to make "counters" a
    processor like any other (the dict can be seeded, snapshotted and
    swapped) without taxing the hot path."""

    def __init__(self, data: Optional[Dict] = None):
        self.data: Dict = {} if data is None else data

    def process(self, event) -> None:
        pass

    def snapshot(self) -> Dict:
        return dict(self.data)


class ListProcessor(Processor):
    """Append every event to ``events`` (tests, ad-hoc inspection)."""

    def __init__(self):
        self.events: List[Any] = []

    def process(self, event) -> None:
        self.events.append(event)

    def of_type(self, *types) -> List[Any]:
        return [e for e in self.events if isinstance(e, types)]


class TimingProcessor(Processor):
    """Host-overhead breakdown from StepDispatch / StepHarvest /
    SegmentDispatch / RunnerComplete events.

    ``summary()`` yields the numbers bench_serving reports per arm:
    total dispatch and fetch-wait seconds (split by step kind), step
    counts, per-step microseconds, and GraphRunner occupancy (exec /
    stall) over the window since construction or the last ``reset()``."""

    def __init__(self):
        # type-keyed dispatch: events this processor ignores (tokens,
        # lifecycle) cost one dict lookup, not an isinstance chain
        self._handlers = {T.StepDispatch: self._step,
                          T.StepHarvest: self._harvest,
                          T.SegmentDispatch: self._segment,
                          T.RunnerComplete: self._runner,
                          T.SchedulerIdle: self._idle}
        self.reset()

    def reset(self) -> None:
        self.dispatch_s: Dict[str, float] = {}
        self.harvest_s: Dict[str, float] = {}
        self.steps: Dict[str, int] = {}
        self.segments = 0
        self.runner_exec_s = 0.0
        self.runner_stall_s = 0.0
        self.idle_waits = 0

    def process(self, event) -> None:
        h = self._handlers.get(type(event))
        if h is not None:
            h(event)

    def _step(self, e) -> None:
        self.dispatch_s[e.kind] = self.dispatch_s.get(e.kind, 0.0) + e.dur
        self.steps[e.kind] = self.steps.get(e.kind, 0) + 1

    def _harvest(self, e) -> None:
        self.harvest_s[e.kind] = self.harvest_s.get(e.kind, 0.0) + e.wait

    def _segment(self, e) -> None:
        self.segments += 1

    def _runner(self, e) -> None:
        self.runner_exec_s += e.wall
        self.runner_stall_s += e.stall

    def _idle(self, e) -> None:
        self.idle_waits += 1

    def summary(self) -> Dict[str, Any]:
        dispatch = sum(self.dispatch_s.values())
        fetch = sum(self.harvest_s.values())
        steps = max(1, sum(self.steps.values()))
        return {
            "dispatch_s": dispatch, "fetch_wait_s": fetch,
            "dispatch_by_kind_ms":
                {k: round(v * 1e3, 3) for k, v in self.dispatch_s.items()},
            "fetch_wait_by_kind_ms":
                {k: round(v * 1e3, 3) for k, v in self.harvest_s.items()},
            "steps": dict(self.steps), "segments": self.segments,
            "dispatch_us_per_step": round(dispatch / steps * 1e6, 1),
            "fetch_wait_us_per_step": round(fetch / steps * 1e6, 1),
            "runner_exec_ms": round(self.runner_exec_s * 1e3, 3),
            "runner_stall_ms": round(self.runner_stall_s * 1e3, 3),
            "idle_waits": self.idle_waits,
        }


class RequestTraceProcessor(Processor):
    """One causal trace per serving request, keyed by ``rid``.

    A trace is the ordered list of this request's lifecycle events
    (submit → admit → prefill → token* → retire); ``trace()``/``pop()``
    return them as JSON-serializable records with the stream clock's
    timestamps.  Events buffer as-is and serialize only on access — an
    emitted event is never mutated afterwards, and per-token dict
    building would otherwise dominate the tracing cost the bench gates.
    Retired traces stay available until ``pop()``/``reset()`` so a
    driver can export and drop them incrementally."""

    def __init__(self):
        self.traces: Dict[int, List[Any]] = {}

    def process(self, event) -> None:
        rid = getattr(event, "rid", None)
        if rid is not None:
            self.traces.setdefault(rid, []).append(event)

    def trace(self, rid: int) -> List[Dict[str, Any]]:
        # imported here: schema imports types, which this module imports
        from repro_torch.core.events.schema import event_to_dict
        return [event_to_dict(e) for e in self.traces.get(rid, [])]

    def pop(self, rid: int) -> List[Dict[str, Any]]:
        out = self.trace(rid)
        self.traces.pop(rid, None)
        return out

    def reset(self) -> None:
        self.traces = {}


class JsonlSink(Processor):
    """Buffered JSONL export: one ``{"type": ..., "ts": ..., ...}`` object
    per line, in emission order.  The per-event cost is ONE list append —
    an emitted event is never mutated afterwards, so serialization
    (event_to_dict + json.dumps) safely defers to ``flush``/``close``;
    this is the path the bench's ≤2 % tracing-overhead gate measures."""

    def __init__(self, path: str):
        self.path = path
        self._events: List[Any] = []

    def process(self, event) -> None:
        self._events.append(event)

    def flush(self) -> None:
        from repro_torch.core.events.schema import event_to_dict
        if self._events:
            with open(self.path, "a") as f:
                f.write("\n".join(json.dumps(event_to_dict(e))
                                  for e in self._events) + "\n")
            self._events = []

    def close(self) -> None:
        self.flush()
