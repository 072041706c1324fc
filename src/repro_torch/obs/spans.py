"""SpanRecorder: keeps the spans an EventStream records (DESIGN.md §15).

    rec = SpanRecorder()
    sched.events.record_spans(rec)      # or engine.events / fn.engine.events
    ...                                 # serve, train
    sched.events.record_spans(None)
    for s in rec.spans(): ...           # name, t0_ns, t1_ns, device_ms, ...

Made while the card is in use, the recorder synchronises it once and
records an anchor event, so each device span's start can be placed on the
host's epoch clock (``device_t0_ns``) as well as timed (``device_ms``).
"""

from __future__ import annotations

import time
from typing import List

import torch

from repro_torch.core.events.spans import Span


class SpanRecorder:
    """An in-memory list of closed spans (appends are atomic, so every
    thread of the engine records into it without a lock)."""

    def __init__(self):
        self._spans: List[Span] = []
        self._anchor = None                 # (CUDA event, epoch ns)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            t = time.time_ns()
            ev.record()
            ev.synchronize()
            self._anchor = (ev, t)

    def record(self, span: Span) -> None:
        self._spans.append(span)

    def spans(self) -> List[Span]:
        """Every span closed so far, in closing order, each device span's
        ``device_ms`` read (after the card has synchronised)."""
        out = list(self._spans)
        pending = [s for s in out if s._ev is not None and s.device_ms is None]
        if pending:
            torch.cuda.synchronize()
        for s in pending:
            start, end = s._ev
            s.device_ms = start.elapsed_time(end)
            if self._anchor is not None:
                ev, t = self._anchor
                s.device_t0_ns = t + int(ev.elapsed_time(start) * 1e6)
        return out
