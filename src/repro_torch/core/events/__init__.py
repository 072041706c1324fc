"""Structured observability layer: typed events, one stream, pluggable
processors (DESIGN.md §13).

    types.py       — the event taxonomy + EVENT_TYPES registry
    stream.py      — EventStream: counter fast path, clock, processors
    processors.py  — Counters / Timing / RequestTrace / Jsonl / List
    schema.py      — JSONL (de)serialization + trace validation
    emit.py        — allocation-light emit helpers for the executor

The engine owns one EventStream for its lifetime (``engine.events``);
``engine.stats`` is the stream's counter dict.  The serving scheduler
shares its engine's stream (one substrate, one clock) and benchmarks
attach processors to derive their breakdowns instead of keeping private
accumulators.
"""

from repro_torch.core.events import types
from repro_torch.core.events.processors import (CountersProcessor,
                                                JsonlSink, ListProcessor,
                                                Processor,
                                                RequestTraceProcessor,
                                                TimingProcessor)
from repro_torch.core.events.schema import (dict_to_event, event_to_dict,
                                            load_jsonl, validate_jsonl)
from repro_torch.core.events.stream import EventStream

__all__ = [
    "types", "EventStream", "Processor", "CountersProcessor",
    "TimingProcessor", "RequestTraceProcessor", "JsonlSink",
    "ListProcessor", "event_to_dict", "dict_to_event", "load_jsonl",
    "validate_jsonl",
]
