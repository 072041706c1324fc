"""Observability layer: profiling, timeline export, live serving metrics
(DESIGN.md §15).

Built entirely on top of ``core/events/`` — nothing here touches the
executor hot path.  The executor's sampled device-time attribution
(``terra.function(profile=N)``) emits ``SegmentProfile`` events through
the same stream every other structured event uses (on a CUDA card its
``device`` time comes from CUDA events recorded around the segment call);
this package consumes them:

* :mod:`repro_torch.obs.metrics` — streaming log-bucketed histograms and
  the :class:`MetricsRegistry` (Prometheus text exposition + JSON snapshot),
  updated online by :class:`MetricsProcessor` from serving events.
* :mod:`repro_torch.obs.trace_viewer` — :class:`TraceViewerExporter`, a
  processor that renders the event stream as Chrome/Perfetto trace-event
  JSON: engine tracks (imperative Python, walker, GraphRunner, device,
  scheduler) plus per-request lanes with flow events linking each
  request's lifecycle and each divergence's recovery chain.
* :mod:`repro_torch.obs.report` — the ``python -m repro_torch.obs.report``
  CLI: per-segment host/device tables, the divergence/replay audit, selector
  distributions, a metrics snapshot, and the ``.trace.json`` export.
* :mod:`repro_torch.obs.http` — stdlib-only optional HTTP scrape endpoint
  serving ``/metrics`` (Prometheus text) and ``/metrics.json``.
"""

from repro_torch.obs.metrics import (GROWTH, Histogram, MetricsProcessor,
                                     MetricsRegistry, counters_table)
from repro_torch.obs.trace_viewer import TraceViewerExporter, chrome_trace

__all__ = ["GROWTH", "Histogram", "MetricsRegistry", "MetricsProcessor",
           "counters_table", "TraceViewerExporter", "chrome_trace"]
