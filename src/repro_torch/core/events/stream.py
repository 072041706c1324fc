"""EventStream: the one instrumentation substrate (DESIGN.md §13).

Every counter bump and every structured lifecycle event in the engine,
executor, scheduler and benchmarks flows through one of these.  The design
constraint is the decode hot path: with no structured processor attached
the stream must cost no more than the ad-hoc ``stats[...] +=`` dicts it
replaced, so the API splits into two tiers:

* **counters** — ``inc`` / ``add`` / ``put`` update the stream's counter
  dict directly (one method call, one dict op, no allocation).  The dict
  is owned by the always-attached :class:`CountersProcessor` and *is* the
  ``engine.stats`` object — bit-compatible with the pre-event-layer
  counters by construction.
* **structured events** — guarded by the ``on`` flag at every emit site
  (``if es.on: es.emit(Evt(...))`` or an ``emit.py`` helper that folds the
  predicate in).  When no structured processor is attached, ``on`` is
  False and **no event object is ever constructed**.

``emit`` stamps ``event.ts`` from the stream's injected clock — there is
exactly one clock per stream (the serving scheduler injects its virtual
clock here once instead of special-casing ``time.perf_counter`` at every
use), and :meth:`sleep` centralizes the only behavioural difference a
virtual clock implies (never sleep real time against a frozen clock).

Processors may be attached/detached at any time; emission is serialized
by a lock because the GraphRunner thread emits completion events
concurrently with the Python thread.

**Spans** (spans.py) are the third tier: ``with es.span(name, **ids)``
times one interval of work on the profiler's epoch clock (not the
injected one) and hands it to the recorder ``record_spans`` set; with
none set, a span site costs one attribute check, as ``if es.on`` does.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.events.processors import CountersProcessor, Processor
from repro_torch.core.events.spans import NO_SPAN, Span


class EventStream:
    """Counter fast path + pluggable structured processors, one clock."""

    def __init__(self, counters: Optional[Dict] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.counters_proc = CountersProcessor(counters)
        self.counters: Dict = self.counters_proc.data
        self.clock = clock
        self._procs: List[Processor] = []
        self.on = False                 # any structured processor attached
        self._lock = threading.Lock()
        self._spans = None              # the span recorder (None: off)

    # ------------------------------------------------------------------
    # counter tier (always on; the hot path)
    # ------------------------------------------------------------------
    def inc(self, key: str, n: int = 1) -> None:
        c = self.counters
        c[key] = c.get(key, 0) + n

    def add(self, key: str, dt: float) -> None:
        c = self.counters
        c[key] = c.get(key, 0.0) + dt

    def put(self, key: str, value) -> None:
        self.counters[key] = value

    def seed(self, defaults: Dict) -> None:
        """Register counter keys without clobbering live values (the
        scheduler seeds its keys into its engine's existing stream)."""
        for k, v in defaults.items():
            self.counters.setdefault(k, v)

    # ------------------------------------------------------------------
    # structured tier (only when a processor is attached)
    # ------------------------------------------------------------------
    def attach(self, proc: Processor) -> Processor:
        with self._lock:
            self._procs.append(proc)
            self.on = True
        return proc

    def detach(self, proc: Processor) -> None:
        with self._lock:
            self._procs = [p for p in self._procs if p is not proc]
            self.on = bool(self._procs)

    def emit(self, event) -> None:
        """Deliver one event to every structured processor.  Callers guard
        with ``es.on`` so the event object exists only when someone
        listens; emitting on a stream that raced to empty is harmless."""
        event.ts = self.clock()
        with self._lock:
            for p in self._procs:
                p.process(event)

    # ------------------------------------------------------------------
    # span tier (only while a recorder is set)
    # ------------------------------------------------------------------
    def record_spans(self, recorder) -> None:
        """Send spans to ``recorder`` (anything with ``record(span)``,
        e.g. ``repro_torch.obs.SpanRecorder``); ``None`` turns them off."""
        self._spans = recorder

    def span(self, name: str, device: bool = False, subs: bool = False,
             **ids):
        """A context timing one interval named ``<layer>.<what>``;
        ``device=True`` also times it on the card's current stream;
        ``subs=True`` lets the code it covers open sub-spans
        (``spans.sub_span``)."""
        rec = self._spans
        if rec is None:
            return NO_SPAN
        return Span(rec, name, device, ids, subs)

    # ------------------------------------------------------------------
    # the injected clock
    # ------------------------------------------------------------------
    def set_clock(self, clock: Callable[[], float]) -> None:
        self.clock = clock

    @property
    def clock_is_real(self) -> bool:
        return self.clock is time.perf_counter

    def sleep(self, seconds: float) -> None:
        """Wait for ``seconds`` of *this stream's* time.  Under the real
        clock that is a bounded real sleep; under an injected (virtual)
        clock real sleeping would hang the caller against frozen time, so
        yield and let the caller re-poll."""
        time.sleep(seconds if self.clock_is_real else 0)

    def close(self) -> None:
        with self._lock:
            procs, self._procs = self._procs, []
            self.on = False
        for p in procs:
            p.close()
