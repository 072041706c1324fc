"""Serving-side instrumentation: the scheduler's view of the EventStream.

The scheduler does not own a private counter dict or clock special-cases
any more (DESIGN.md §13): under co-execution it shares its engine's
EventStream — one substrate, one injected clock, one flat counter dict
merging ``engine.stats`` and the scheduler counters — and under
``use_terra=False`` it gets a fresh stream seeded with the same keys.
The helpers below fold the ``es.on`` hot-path predicate exactly like
``core.events.emit`` does for the executor; request-lifecycle events are
keyed by the ``rid`` the scheduler stamps at submission (a resubmitted
request starts a fresh lifecycle, so it gets a fresh rid).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.core.events import EventStream
from repro_torch.core.events import types as T

# counter keys the scheduler contributes to the shared stream; the same
# registry role executor/stats.py plays for the engine
SCHED_DEFAULTS = {
    "admitted": 0, "retired": 0, "decode_steps": 0, "prefill_steps": 0,
    "prefill_tokens": 0, "generated_tokens": 0, "idle_waits": 0,
    "step_dispatch_time": 0.0, "harvest_wait_time": 0.0,
}


def make_stream(engine_events: Optional[EventStream],
                clock: Callable[[], float]) -> EventStream:
    """The scheduler's stream: the engine's (use_terra — scheduler and
    engine counters unify into one dict) or a fresh one (baseline).  The
    scheduler's clock is injected once here; every event timestamp and
    every idle sleep decision flows from it."""
    es = engine_events if engine_events is not None else EventStream()
    es.seed(SCHED_DEFAULTS)
    es.set_clock(clock)
    return es


# --------------------------------------------------------------------------
# request lifecycle (submit -> admit -> prefill -> token* -> retire)
# --------------------------------------------------------------------------

def merged_stats(sch) -> dict:
    """The scheduler's flat ``stats`` view: the shared counter dict (which
    already holds the engine counters under co-execution), the callback /
    pool gauges, and the engine phase."""
    out = dict(sch.sched_stats)
    out["callbacks_delivered"] = sch.callbacks.delivered
    out["peak_resident_tokens"] = sch.pool.peak_resident_tokens
    if sch.use_terra:
        out.update(sch._tf.stats)
        out["phase"] = sch._tf.phase
    return out


def request_submit(es: EventStream, req, rid: int) -> None:
    req.rid = rid
    if es.on:
        es.emit(T.RequestSubmit(rid, len(req.prompt),
                                int(req.max_new_tokens)))


def admitted(es: EventStream, plan, now: float) -> None:
    """Admission events for one PrefillPlan: each real row gets an Admit
    (with its queueing delay) and a Prefill at the group's bucket."""
    if not es.on:
        return
    for i, req in enumerate(plan.requests):
        queued = max(0.0, now - (req.arrival_time or now))
        es.emit(T.RequestAdmit(req.rid, int(plan.slots[i]), queued))
        es.emit(T.RequestPrefill(req.rid, int(plan.bucket),
                                 len(req.prompt)))


def prefill_admitted(sch, plan, sp) -> int:
    """Count one admission prefill (its step, rows and real prompt
    tokens), emit its admission events and name its rows on its dispatch
    span ``sp``; returns the prompt tokens."""
    st, n = sch.sched_stats, len(plan.requests)
    tokens = int(plan.lengths[:n].sum())
    st["prefill_steps"] += 1
    st["admitted"] += n
    st["prefill_tokens"] += tokens
    if sp:
        sp.ids.update(rows=n, bucket=int(plan.bucket), tokens=tokens,
                      rids=[r.rid for r in plan.requests])
    admitted(sch.events, plan, sch.clock())
    return tokens


def prefill_span(es: EventStream, plan, tokens: int):
    """The device-timed ``step.prefill`` span around one prefill's
    launches, naming its rows' requests and real prompt tokens; the
    model's sub-layers are device-timed spans inside it
    (``step.prefill.mixer``, ``.attention``, ``.moe``)."""
    sp = es.span("step.prefill", device=True, subs=True)
    if sp:
        sp.ids.update(rids=[r.rid for r in plan.requests], tokens=tokens)
    return sp


def request_token(es: EventStream, req, token: int) -> None:
    if es.on:
        es.emit(T.RequestToken(req.rid, int(token),
                               len(req.out_tokens) - 1))


def request_retire(es: EventStream, req) -> None:
    if es.on:
        es.emit(T.RequestRetire(req.rid,
                                "eos" if req.done else "budget",
                                len(req.out_tokens)))


# --------------------------------------------------------------------------
# step loop
# --------------------------------------------------------------------------

def step_dispatch(es: EventStream, kind: str, rows: int, dur: float,
                  queue_depth: int = 0, resident: int = 0) -> None:
    if es.on:
        es.emit(T.StepDispatch(kind, rows, dur, int(queue_depth),
                               int(resident)))


def step_harvest(es: EventStream, kind: str, wait: float) -> None:
    if es.on:
        es.emit(T.StepHarvest(kind, wait))


def step_done(sch, kind: str, rows: int, t0: float) -> None:
    """Close one dispatch: accumulate the host-time counter and emit the
    StepDispatch event carrying the live queue-depth / resident-token
    gauges (the metrics registry samples them from here)."""
    dur = time.perf_counter() - t0
    sch.sched_stats["step_dispatch_time"] += dur
    step_dispatch(sch.events, kind, rows, dur,
                  len(sch.queue), sch.pool.resident_tokens)


def harvest_done(sch, kind: str, t0: float) -> None:
    wait = time.perf_counter() - t0
    sch.sched_stats["harvest_wait_time"] += wait
    step_harvest(sch.events, kind, wait)


def idle(es: EventStream, wait) -> None:
    if es.on:
        es.emit(T.SchedulerIdle(float(wait or 0.0)))


# --------------------------------------------------------------------------
# observability surface (repro_torch.obs, DESIGN.md §15)
# --------------------------------------------------------------------------

def set_profile(sch, every: int) -> None:
    """(Re)set the sampled device-time profiling cadence — mutable at
    runtime so a serving process can turn attribution on for a window
    and back off without restarting.  A ``use_terra=False`` scheduler has
    no engine to sample: a no-op there, as in the reference."""
    if sch.use_terra:
        sch._tf.engine.profile_every = int(every)


def enable_metrics(sch, registry=None):
    """Attach a live :class:`repro_torch.obs.MetricsProcessor` to the
    scheduler's event stream; returns the registry (serve it with
    ``repro_torch.obs.http.MetricsServer`` for Prometheus scrapes)."""
    from repro_torch.obs import MetricsProcessor
    mp = MetricsProcessor(registry)
    mp.registry.attach_counters(sch.sched_stats)
    sch.events.attach(mp)
    sch.metrics = mp.registry
    return mp.registry
