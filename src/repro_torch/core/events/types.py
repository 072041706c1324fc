"""Typed event taxonomy for the structured observability layer.

Every instrumented moment of the co-execution lifecycle is one of the
dataclasses below (DESIGN.md §13): iteration open/close, segment dispatch
and GraphRunner completion, walker validation outcomes, the divergence →
rollback → replay chain (causally linked by ``iter_id``), steady-state
entry/exit/probe/poison, pass-pipeline runs, and the serving request
lifecycle (submit → admit → prefill → per-token → retire, keyed by
``rid``).

Events are cheap plain dataclasses constructed **only** when a structured
processor is attached to the stream (``EventStream.on``); the counters-only
path never builds one.  ``ts`` is stamped by the stream's injected clock at
emit time, so all timestamps in one stream share one clock and are monotone
per emitting thread.  The ``EVENT_TYPES`` registry is the JSONL schema:
``schema.py`` round-trips events through it and rejects unknown types or
field sets.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

EVENT_TYPES: Dict[str, type] = {}


def _event(cls):
    cls = dataclasses.dataclass(cls)
    EVENT_TYPES[cls.__name__] = cls
    return cls


class Event:
    """Base class; ``ts`` is stamped by :meth:`EventStream.emit`."""
    ts: Optional[float] = None


# --------------------------------------------------------------------------
# engine iteration lifecycle
# --------------------------------------------------------------------------

@_event
class IterationStart(Event):
    iter_id: int
    mode: str                       # "tracing" | "skeleton"
    family: str                     # short digest of the family key


@_event
class IterationEnd(Event):
    iter_id: int
    mode: str
    traced: bool                    # ended through the tracing path
    ops_validated: int = 0          # walker outcome (skeleton iterations)
    fast_hits: int = 0              # ... of which via the stamp fast path


@_event
class Transition(Event):
    """Phase transition into co-execution (tracing -> skeleton)."""
    iter_id: int


@_event
class FamilySwitch(Event):
    """Shape-class change at iteration start (DESIGN.md §8)."""
    family: str
    created: bool                   # True: new class (will trace)


# --------------------------------------------------------------------------
# segment dispatch / runner completion
# --------------------------------------------------------------------------

@_event
class SegmentDispatch(Event):
    iter_id: int
    kind: str                       # "segment" | "chain" | "steady"
    index: int                      # segment index (-1 for chains)
    seq: int                        # GraphRunner submit sequence
    feeds: int = 0                  # Input Feeding values shipped


@_event
class RunnerComplete(Event):
    """One GraphRunner closure finished (emitted from the runner thread);
    joins to :class:`SegmentDispatch` on ``seq``."""
    seq: int
    wall: float                     # closure execution wall time
    stall: float                    # queue-empty time before it started


@_event
class SegmentProfile(Event):
    """Sampled device-time attribution for one dispatched segment
    (DESIGN.md §15): on a profiling iteration the GraphRunner thread
    blocks on the segment's outputs and stamps host dispatch time and
    dispatch-to-device-done wall separately.  Joins to
    :class:`SegmentDispatch` on ``(iter_id, kind, index)``; ``kernels``
    lists the Pallas-substituted ops baked into the segment (pass
    metadata carried through the DispatchPlan)."""
    iter_id: int
    kind: str                       # "segment" | "chain" | "steady"
    index: int
    dispatch: float                 # host time in the dispatch call
    device: float                   # dispatch start -> outputs ready
    kernels: Tuple[str, ...] = ()


# --------------------------------------------------------------------------
# divergence -> rollback -> replay/retrace (causally linked by iter_id)
# --------------------------------------------------------------------------

@_event
class Divergence(Event):
    iter_id: int
    reason: str


@_event
class Rollback(Event):
    """Pending symbolic work cancelled + variable store restored to the
    iteration-start snapshot."""
    iter_id: int
    vars_restored: int = 0


@_event
class Replay(Event):
    """Validated prefix replayed eagerly (the divergence recovery); the
    iteration then finishes imperatively and re-enters tracing."""
    iter_id: int
    entries: int = 0


@_event
class Retrace(Event):
    """Re-entered tracing without a replay (an aborted iteration)."""
    iter_id: int
    reason: str = ""


# --------------------------------------------------------------------------
# zero-walker steady state (DESIGN.md §12)
# --------------------------------------------------------------------------

@_event
class SteadyEnter(Event):
    iter_id: int
    family: str = ""


@_event
class SteadyExit(Event):
    iter_id: int
    reason: str = ""


@_event
class SteadyProbe(Event):
    """A forced walker validation iteration (every steady_probe-th call)."""
    iter_id: int


@_event
class SteadyPoison(Event):
    """Python observed device state inside an open skeleton iteration;
    the current streak cannot enter (or stay in) steady state."""
    iter_id: int


# --------------------------------------------------------------------------
# symbolic optimization pass pipeline (DESIGN.md §10)
# --------------------------------------------------------------------------

@_event
class PassPipelineRun(Event):
    iter_id: int
    family: str
    pipeline: Tuple[str, ...]
    deltas: Any                     # {pass name: {counter: delta}}


# --------------------------------------------------------------------------
# serving request lifecycle + scheduler steps (DESIGN.md §11/§13)
# --------------------------------------------------------------------------

@_event
class RequestSubmit(Event):
    rid: int
    prompt_len: int
    max_new: int


@_event
class RequestAdmit(Event):
    rid: int
    slot: int
    queued_s: float = 0.0           # arrival -> admission wait


@_event
class RequestPrefill(Event):
    rid: int
    bucket: int                     # padded prompt length
    prompt_len: int


@_event
class RequestToken(Event):
    rid: int
    token: int
    index: int                      # position in the request's output


@_event
class RequestRetire(Event):
    rid: int
    reason: str                     # "eos" | "budget"
    tokens: int


@_event
class ForkObserved(Event):
    """A control-flow fork's case selection observed during skeleton
    validation (groundwork for JANUS-style speculation): per-family
    selector distributions accumulate on the TraceFamily and each
    observation is emitted for offline analysis."""
    family: str                     # short digest of the family key
    fork: int                       # fork node uid in the TraceGraph
    case: int                       # matched case index


@_event
class StepDispatch(Event):
    """One scheduler step dispatched (decode or prefill)."""
    kind: str                       # "decode" | "prefill"
    rows: int
    dur: float                      # host time spent dispatching
    queue_depth: int = 0            # arrivals waiting for a slot
    resident: int = 0               # KV tokens resident in the pool


@_event
class StepHarvest(Event):
    """The lagged harvest of a step's token frame."""
    kind: str
    wait: float                     # host time blocked on the fetch


@_event
class SchedulerIdle(Event):
    wait: float                     # seconds until the next known arrival


# -- persistence (core/persist/, DESIGN.md §14) ------------------------------

@_event
class ArtifactHit(Event):
    """A warm boot loaded an artifact instead of tracing/compiling."""
    kind: str                       # "family" | "segment"
    key: str                        # store-relative artifact path


@_event
class ArtifactMiss(Event):
    kind: str
    key: str
    reason: str = ""                # "absent" | "corrupt" | ...


@_event
class ArtifactStore(Event):
    """An artifact was written to the persistent store."""
    kind: str
    key: str
    nbytes: int = 0


@_event
class CheckpointSave(Event):
    path: str
    vars_saved: int = 0
    requests: int = 0               # scheduler checkpoints: live requests


@_event
class CheckpointRestore(Event):
    path: str
    vars_restored: int = 0
    requests: int = 0
