"""The traced run: ``torch.profiler`` over the measured window, read back
as device intervals, kernel times and counts by name, and the
benchmark's own host spans.

Busy time is the union of the intervals in which any operation (kernel,
copy or fill) ran on the device, so operations that overlap on two
streams count once.  Host spans are ``record_function`` annotations named
``portbench.<what>`` that the drivers open around their calls into the
program; an idle gap of the device is charged to the innermost span that
covers its middle."""

from __future__ import annotations

import collections
import contextlib
import re
import time
from typing import List, Optional, Tuple

from portbench.core import stats

SPAN_PREFIX = "portbench."


class Trace:
    """What one profiled window holds (times in seconds, on the trace's
    clock)."""

    def __init__(self, device_ops, kernels, spans, window):
        self.device_ops = device_ops    # [(name, start, end)] every op
        self.kernels = kernels          # [(name, start, end, stream)]
        self.spans = spans              # [(name, start, end)] host spans
        self.window = window            # (start, end)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return stats.busy([(s, e) for _, s, e in self.device_ops],
                          *self.window)

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for k in self.kernels if rx.search(k[0]))

    def kernel_time(self, pattern: str) -> float:
        """Summed device time of the kernels whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e, _ in self.kernels if rx.search(n))

    def following(self, pattern: str) -> List[Tuple[str, float, float, int]]:
        """For each kernel matching ``pattern``, the next kernel on its
        stream (the same stream runs in order)."""
        rx = re.compile(pattern)
        by_stream = collections.defaultdict(list)
        for k in self.kernels:
            by_stream[k[3]].append(k)
        out = []
        for ks in by_stream.values():
            ks.sort(key=lambda k: k[1])
            out += [ks[i + 1] for i, k in enumerate(ks[:-1])
                    if rx.search(k[0])]
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the host span that covered them."""
        by_op = collections.Counter()
        for n, s, e in self.device_ops:
            by_op[n] += e - s
        by_span = collections.Counter()
        spans = sorted(self.spans, key=lambda x: x[1])
        for s, e in stats.gaps([(s, e) for _, s, e in self.device_ops],
                               *self.window):
            mid = (s + e) / 2
            inner = [x for x in spans if x[1] <= mid <= x[2]]
            name = (min(inner, key=lambda x: x[2] - x[1])[0] if inner
                    else "no span")
            by_span[name] += e - s
        return {"device_ops": [[n, t] for n, t in by_op.most_common(top)],
                "idle_gaps": [[n, t] for n, t in by_span.most_common(top)]}


class Tracer:
    """Profiles the window when ``on``: the whole of it, or, with
    ``sub = (after_s, length_s)``, the part from ``after_s`` seconds into
    it for ``length_s`` seconds (a serving window's trace is too large to
    read whole within a run's time).  The driver calls ``tick`` often
    (each scheduler step).  ``span`` names host
    work while the profiler runs (a no-op otherwise).  ``on_edge`` runs just
before the profiler starts and just before it stops (the device
synchronised), so the driver can settle its work and read its counters
over the traced span."""

    def __init__(self, on: bool, sub=None, on_edge=None):
        self.on, self.sub, self.on_edge = on, sub, on_edge
        self._prof = None
        self._t0 = None
        self._bounds = [None, None]         # epoch seconds, trace clock
        self.trace: Optional[Trace] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(SPAN_PREFIX + name)

    def _start(self):
        import torch
        from torch.autograd import profiler
        if self.on_edge is not None:
            self.on_edge()
        self._prof = profiler.profile(
            use_device="cuda" if torch.cuda.is_available() else None,
            use_kineto=True)
        self._prof.__enter__()
        self._bounds[0] = time.time_ns() * 1e-9

    def _stop(self):
        import torch
        from torch.autograd import profiler
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._bounds[1] = time.time_ns() * 1e-9
        if self.on_edge is not None:
            self.on_edge()
        # the raw results, without the profiler's own Python pass over
        # every event
        results = profiler._disable_profiler()
        self._prof = None
        self.trace = read(results, tuple(self._bounds))

    def tick(self) -> None:
        if not self.on or self.sub is None or self.trace is not None:
            return
        now = time.perf_counter() - self._t0
        if self._prof is None and now >= self.sub[0]:
            self._start()
        elif self._prof is not None and now >= self.sub[0] + self.sub[1]:
            self._stop()

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self.on and self.sub is None:
            self._start()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            if exc[0] is None:
                self._stop()
            else:
                from torch.autograd import profiler
                profiler._disable_profiler()
                self._prof = None
        return False


def read(results, window) -> Trace:
    """The profiler's raw results as a :class:`Trace` of ``window``."""
    from torch.autograd import DeviceType
    ops, kernels, spans = [], [], []
    for ev in results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith(SPAN_PREFIX):     # a span's device shadow
                continue
            ops.append((name, s, e))
            if not name.startswith(("Memcpy", "Memset")):
                kernels.append((name, s, e, ev.device_resource_id()))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], s, e))
    return Trace(ops, kernels, spans, window)

