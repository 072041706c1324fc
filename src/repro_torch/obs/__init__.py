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
* :mod:`repro_torch.obs.spans` — :class:`SpanRecorder`, which keeps the
  spans the program records while it is set on a stream:

      rec = SpanRecorder()
      sched.events.record_spans(rec)    # a scheduler's, an engine's stream
      ...
      sched.events.record_spans(None)
      spans = rec.spans()               # device_ms read after a sync

  Each span has ``name``, ``t0_ns``/``t1_ns`` (epoch ns, the clock
  ``torch.profiler`` stamps its events on), ``thread``, ``parent`` (the
  id of the enclosing span on that thread), ``ids``, and for a
  device-timed span ``device_ms``.  What each covers:

  ==========================  =========================================
  ``sched.step``              one pass of the scheduler loop (``step``)
  ``sched.plan``              choosing the pass's plan (``next_plan``)
  ``sched.dispatch.decode``   dispatching a decode step (``rows``,
                              ``rids``)
  ``sched.dispatch.prefill``  dispatching an admission prefill
                              (``rows``, ``rids``, ``bucket``,
                              ``tokens``)
  ``sched.fetch``             blocking on a step's token frame; ``step``
                              is the step harvested
  ``sched.deliver``           recording tokens, retiring requests and
                              running the streaming callbacks
  ``sched.idle``              waiting with nothing to run
  ``engine.call``             one ``TerraFunction`` call (``it``)
  ``engine.fetch``            the Python thread stalled at a fetch point
                              (the time ``py_stall_time`` adds up)
  ``runner.<kind>``           one GraphRunner closure on its thread
                              (``segment``, ``chain``, ``steady``,
                              ``varop``, ``snapshot``; ``seq``)
  ``capture.copy_in``         copying arguments into a captured graph's
                              static buffers (device-timed)
  ``capture.replay``          launching a captured CUDA graph
                              (device-timed)
  ``capture.copy_back``       copying donated arguments' new values back
                              (device-timed)
  ``capture.copy_out``        copying a replay's outputs out of the
                              graph's pool (device-timed)
  ``capture.record``          capturing (or recapturing) a graph
  ``step.prefill``            the prefill step's launches (``rids``,
                              ``tokens``; device-timed)
  ``step.prefill.mixer``      inside ``step.prefill``: one Mamba-2
                              mixer sub-layer (device-timed)
  ``step.prefill.attention``  one attention sub-layer (device-timed)
  ``step.prefill.moe``        one MoE FFN sub-layer (device-timed)
  ==========================  =========================================

  ``chrome_trace(events, spans)`` draws them beside the events.
"""

from repro_torch.obs.metrics import (GROWTH, Histogram, MetricsProcessor,
                                     MetricsRegistry, counters_table)
from repro_torch.obs.spans import SpanRecorder
from repro_torch.obs.trace_viewer import TraceViewerExporter, chrome_trace

__all__ = ["GROWTH", "Histogram", "MetricsRegistry", "MetricsProcessor",
           "counters_table", "SpanRecorder", "TraceViewerExporter",
           "chrome_trace"]
