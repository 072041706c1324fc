"""Structured observability layer: typed events, one stream, pluggable
processors (DESIGN.md §13).

    types.py       — the event taxonomy + EVENT_TYPES registry
    stream.py      — EventStream: counter fast path, clock, processors
    processors.py  — Counters / Timing / List
    emit.py        — allocation-light emit helpers for the executor

The JSONL schema, ``JsonlSink`` and ``RequestTraceProcessor`` arrive with
the port's observability slice.

The engine owns one EventStream for its lifetime (``engine.events``);
``engine.stats`` is the stream's counter dict.  The serving scheduler
shares its engine's stream (one substrate, one clock) and benchmarks
attach processors to derive their breakdowns instead of keeping private
accumulators.
"""

from repro_torch.core.events import types
from repro_torch.core.events.processors import (CountersProcessor,
                                                ListProcessor, Processor,
                                                TimingProcessor)
from repro_torch.core.events.stream import EventStream

__all__ = [
    "types", "EventStream", "Processor", "CountersProcessor",
    "TimingProcessor", "ListProcessor",
]
