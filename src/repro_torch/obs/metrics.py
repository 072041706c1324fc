"""Live metrics: streaming log-bucketed histograms + registry (§15).

The serving benchmarks used to buffer every latency sample and call
``np.percentile`` after the run; a serving process cannot do that — it
needs percentiles *online*, with bounded memory, updated from the same
event stream everything else reads.  :class:`Histogram` is the standard
log-bucketed answer: values map to geometric buckets (growth factor
1.05 ⇒ any percentile is exact to within ±2.5 % relative error), stored
sparsely, so an arbitrary stream costs O(occupied buckets) memory and
one dict update per observation.  :class:`MetricsRegistry` names a set
of histograms + gauges and renders them two ways — a JSON snapshot (the
benchmarks' one formatting path for stats) and Prometheus text
exposition (scraped via :mod:`repro_torch.obs.http`).
:class:`MetricsProcessor` is the event-stream adapter: a handler-dict
processor (same shape as ``TimingProcessor``) that folds
serving/request/engine events into the registry as they are emitted.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from repro_torch.core.events import types as T
from repro_torch.core.events.processors import Processor

GROWTH = 1.05
_LOG_G = math.log(GROWTH)


class Histogram:
    """Sparse log-bucketed streaming histogram for non-negative samples.

    Bucket ``i`` covers ``[GROWTH**i, GROWTH**(i+1))``; values ``<= 0``
    land in a dedicated underflow bucket (reported as 0.0).  Percentiles
    return the geometric midpoint of the containing bucket, so relative
    error is bounded by ``sqrt(GROWTH) - 1`` (~2.47 %) regardless of the
    distribution — the property tests/test_obs.py checks against numpy.
    """

    __slots__ = ("buckets", "count", "total", "vmin", "vmax", "zeros")

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.zeros = 0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= 0.0:
            self.zeros += 1
            return
        i = int(math.floor(math.log(v) / _LOG_G))
        self.buckets[i] = self.buckets.get(i, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Geometric-midpoint percentile; exact for the underflow bucket
        and clamped to the observed min/max so p0/p100 stay honest."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.count))
        if rank <= self.zeros:
            return 0.0
        seen = self.zeros
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= rank:
                mid = GROWTH ** (i + 0.5)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def snapshot(self) -> Dict[str, Any]:
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p95": self.percentile(95), "p99": self.percentile(99)}

    def cumulative_buckets(self) -> List:
        """(upper_bound, cumulative_count) per occupied bucket, for
        Prometheus exposition (le-labelled, cumulative by contract)."""
        out, cum = [], self.zeros
        if self.zeros:
            out.append((0.0, cum))
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            out.append((GROWTH ** (i + 1), cum))
        return out


class MetricsRegistry:
    """Named histograms + gauges with two render paths.

    ``snapshot()`` is the JSON dict the benchmarks and the report CLI
    print; ``prometheus_text()`` is the ``text/plain; version=0.0.4``
    exposition the scrape endpoint serves.  Counter dicts (the stream's
    flat counters) can be attached and are exported as untyped gauges.
    """

    def __init__(self):
        self.histograms: Dict[str, Histogram] = {}
        self.gauges: Dict[str, float] = {}
        self.counters: Optional[Dict[str, Any]] = None

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauges[name] = v

    def attach_counters(self, counters: Dict[str, Any]) -> None:
        self.counters = counters

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self.histograms.items())},
            "gauges": dict(sorted(self.gauges.items()))}
        if self.counters is not None:
            out["counters"] = {k: v for k, v in sorted(self.counters.items())
                               if isinstance(v, (int, float))}
        return out

    def prometheus_text(self, prefix: str = "terra") -> str:
        lines: List[str] = []
        for name, h in sorted(self.histograms.items()):
            m = f"{prefix}_{name}"
            lines.append(f"# TYPE {m} histogram")
            for le, cum in h.cumulative_buckets():
                lines.append(f'{m}_bucket{{le="{le:.6g}"}} {cum}')
            lines.append(f'{m}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{m}_sum {h.total:.9g}")
            lines.append(f"{m}_count {h.count}")
        for name, v in sorted(self.gauges.items()):
            m = f"{prefix}_{name}"
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {v:.9g}")
        if self.counters is not None:
            for name, v in sorted(self.counters.items()):
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                m = f"{prefix}_{name}"
                lines.append(f"# TYPE {m} counter")
                lines.append(f"{m} {v:.9g}")
        return "\n".join(lines) + "\n"


class MetricsProcessor(Processor):
    """Event-stream adapter: folds serving events into a registry online.

    Histograms maintained (units in the name):

    * ``ttft_ms`` — RequestSubmit → first RequestToken wall per request
    * ``token_latency_ms`` — inter-token gap per request
    * ``queue_wait_ms`` — admission queueing delay (RequestAdmit)
    * ``dispatch_us`` / ``fetch_us`` — per-step scheduler host time
    * ``queue_depth`` / ``resident_tokens`` — sampled at each StepDispatch

    Gauges: last queue depth / resident tokens, steady-state occupancy
    (fraction of dispatched segments that took the zero-walker path).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._submit_ts: Dict[int, float] = {}
        self._last_token_ts: Dict[int, float] = {}
        self._segments = 0
        self._steady_segments = 0
        self._handlers = {T.RequestSubmit: self._submit,
                          T.RequestAdmit: self._admit,
                          T.RequestToken: self._token,
                          T.RequestRetire: self._retire,
                          T.StepDispatch: self._step,
                          T.StepHarvest: self._harvest,
                          T.SegmentDispatch: self._segment,
                          T.SegmentProfile: self._profile}

    def process(self, event) -> None:
        h = self._handlers.get(type(event))
        if h is not None:
            h(event)

    # -- request lifecycle -------------------------------------------------
    def _submit(self, e) -> None:
        self._submit_ts[e.rid] = e.ts

    def _admit(self, e) -> None:
        self.registry.observe("queue_wait_ms", e.queued_s * 1e3)

    def _token(self, e) -> None:
        r = self.registry
        last = self._last_token_ts.get(e.rid)
        if last is not None:
            r.observe("token_latency_ms", (e.ts - last) * 1e3)
        elif e.rid in self._submit_ts:
            r.observe("ttft_ms", (e.ts - self._submit_ts[e.rid]) * 1e3)
        self._last_token_ts[e.rid] = e.ts

    def _retire(self, e) -> None:
        self._submit_ts.pop(e.rid, None)
        self._last_token_ts.pop(e.rid, None)

    # -- scheduler step loop ----------------------------------------------
    def _step(self, e) -> None:
        r = self.registry
        r.observe("dispatch_us", e.dur * 1e6)
        r.observe("queue_depth", float(e.queue_depth))
        r.observe("resident_tokens", float(e.resident))
        r.set_gauge("queue_depth", float(e.queue_depth))
        r.set_gauge("resident_tokens", float(e.resident))

    def _harvest(self, e) -> None:
        self.registry.observe("fetch_us", e.wait * 1e6)

    # -- engine dispatch --------------------------------------------------
    def _segment(self, e) -> None:
        self._segments += 1
        if e.kind == "steady":
            self._steady_segments += 1
        self.registry.set_gauge(
            "steady_occupancy", self._steady_segments / self._segments)

    def _profile(self, e) -> None:
        r = self.registry
        r.observe("segment_dispatch_us", e.dispatch * 1e6)
        r.observe("segment_device_us", e.device * 1e6)


def counters_table(stats: Dict[str, Any],
                   keys: Optional[List[str]] = None) -> str:
    """One formatting path for counter dicts (fig6_breakdown, report CLI):
    aligned ``name value`` rows over the numeric entries of ``stats``."""
    items = [(k, stats[k]) for k in (keys if keys is not None
                                     else sorted(stats))
             if isinstance(stats.get(k), (int, float))
             and not isinstance(stats.get(k), bool)]
    if not items:
        return "(no counters)"
    w = max(len(k) for k, _ in items)
    rows = []
    for k, v in items:
        sv = f"{v:.6f}".rstrip("0").rstrip(".") if isinstance(v, float) \
            else str(v)
        rows.append(f"  {k:<{w}}  {sv}")
    return "\n".join(rows)
