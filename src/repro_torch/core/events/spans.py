"""Spans: named intervals of work on the profiler's clock (DESIGN.md §15).

``EventStream.span(name, device=False, **ids)`` opens one.  With no
recorder on the stream (``record_spans(None)``, the default) the call
returns the shared :data:`NO_SPAN` after one attribute check: no object is
built and no CUDA event is recorded.  With a recorder
(``repro_torch.obs.SpanRecorder``) a :class:`Span` stamps
``time.time_ns()`` on entry and exit — the epoch clock ``torch.profiler``
stamps its events on, so a span lines up with a device trace — and
records its thread, its parent (the innermost span open on that thread),
its ids, and, for ``device=True``, a pair of timing CUDA events on the
current stream (never while that stream is being captured into a CUDA
graph).  A site that computes an id only when spans record reads the span
as a bool: ``NO_SPAN`` is false.

A span opened with ``subs=True`` (the scheduler's ``step.prefill``) asks
for the sub-spans of the code it covers: while it is open on a thread,
:func:`sub_span` there opens a device-timed span nested in it, on its
recorder; elsewhere :func:`sub_span` returns :data:`NO_SPAN` after one
attribute check.  The model's layers open them (``step.prefill.mixer``,
``.attention``, ``.moe``) without a stream of their own.

Spans go to the recorder only, never through ``emit``: the structured
event stream stays what it is without them.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

# ids are unique in the process, so a parent link holds across streams
# (an engine's spans nest in its scheduler's on one thread)
_IDS = itertools.count(1)
_OPEN = threading.local()           # .stack: this thread's open spans
_SUBS = threading.local()           # .span: the open span asking for subs


class _NoSpan:
    """The shared context every span site gets while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


NO_SPAN = _NoSpan()


def _timing_event():
    """A timing CUDA event recorded on the current stream, or None where
    no card is in use or the stream is being captured."""
    if not torch.cuda.is_initialized() or \
            torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Span:
    """One recorded interval.  ``t0_ns``/``t1_ns`` are epoch nanoseconds;
    ``parent`` is the id of the enclosing span on ``thread`` (None at the
    top); ``device_ms`` (and ``device_t0_ns``, where the recorder anchored
    the card's clock) are filled in by ``SpanRecorder.spans()``."""

    __slots__ = ("name", "id", "parent", "thread", "thread_name", "ids",
                 "t0_ns", "t1_ns", "device_ms", "device_t0_ns", "_rec",
                 "_device", "_ev", "_subs", "_outer")

    def __init__(self, rec, name: str, device: bool, ids: dict,
                 subs: bool = False):
        self._rec, self.name, self._device, self.ids = rec, name, device, ids
        self.device_ms = self.device_t0_ns = self._ev = None
        self._subs, self._outer = subs, None

    def __enter__(self):
        try:
            stack = _OPEN.stack
        except AttributeError:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        t = threading.current_thread()
        self.thread, self.thread_name = t.ident, t.name
        stack.append(self)
        if self._subs:
            self._outer = getattr(_SUBS, "span", None)
            _SUBS.span = self
        if self._device:
            self._ev = _timing_event()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        if self._ev is not None:
            end = _timing_event()
            self._ev = (self._ev, end) if end is not None else None
        _OPEN.stack.pop()
        if self._subs:
            _SUBS.span = self._outer
        self._rec.record(self)
        return False


def sub_span(name: str):
    """A device-timed span ``name`` inside the ``subs=True`` span open on
    this thread (on its recorder), or :data:`NO_SPAN` when there is none."""
    outer = getattr(_SUBS, "span", None)
    if outer is None:
        return NO_SPAN
    return Span(outer._rec, name, True, {})
