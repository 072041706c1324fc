"""Spans (``EventStream.span``, ``repro_torch.obs.SpanRecorder``) on the
CPU: off, they cost a shared no-op and record nothing; on, one served run
of the ``smoke_config("llama3-8b")`` scheduler nests its loop's spans
under ``sched.step``, names the step each harvest fetches, runs the
GraphRunner's spans on its own thread with their dispatch's sequence
number, and names each prefill's requests and prompt tokens.  The event
stream is the same with spans on as off.  On a card, a captured
program's replays record their copies with device times."""

import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import function, ops  # noqa: E402
from repro_torch.core.events import EventStream, ListProcessor  # noqa: E402
from repro_torch.core.events import spans as spans_mod  # noqa: E402
from repro_torch.core.events import stream as stream_mod  # noqa: E402
from repro_torch.core.events import types as T  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.obs import SpanRecorder, chrome_trace  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler  # noqa

LENS, MNS = [5, 8, 13, 8, 5, 16], [4, 9, 3, 5, 7, 4]
SCHED_CHILDREN = ("sched.plan", "sched.dispatch.decode",
                  "sched.dispatch.prefill", "sched.fetch", "sched.deliver",
                  "sched.idle")


@pytest.fixture(scope="module")
def llama():
    cfg = smoke_config("llama3-8b")
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


def requests(cfg):
    rng = np.random.RandomState(1)
    return [Request(prompt=rng.randint(0, cfg.vocab, L).astype(np.int32),
                    max_new_tokens=mn, arrival_time=0.0)
            for L, mn in zip(LENS, MNS)]


def serve(llama, recorder=None, **kw):
    """One served run -> (requests, events, the scheduler's stats)."""
    cfg, params = llama
    sch = ContinuousBatchingScheduler(cfg, params, max_slots=3, max_len=64,
                                      steady_state=4, device="cpu", **kw)
    lp = sch.events.attach(ListProcessor())
    sch.events.record_spans(recorder)
    reqs = sch.serve(requests(cfg))
    sch.events.record_spans(None)
    stats = sch.stats
    sch.close()
    return reqs, lp.events, stats


class _Counting(SpanRecorder):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def record(self, span):
        self.calls += 1
        super().record(span)


@pytest.fixture(scope="module")
def on(llama):
    rec = SpanRecorder()
    reqs, events, _ = serve(llama, rec)
    return reqs, events, rec.spans()


def test_span_is_a_shared_no_op_without_a_recorder():
    es = EventStream()
    assert es.span("x.y", a=1) is spans_mod.NO_SPAN
    with es.span("x.y", device=True) as sp:
        assert not sp
    rec = SpanRecorder()
    es.record_spans(rec)
    with es.span("x.outer", a=1) as outer:
        assert outer
        with es.span("x.inner", device=True) as inner:
            pass
    es.record_spans(None)
    assert es.span("x.y") is spans_mod.NO_SPAN
    got = rec.spans()
    assert [s.name for s in got] == ["x.inner", "x.outer"]
    assert inner.parent == outer.id and outer.parent is None
    assert outer.ids == {"a": 1}
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    assert inner.device_ms is None          # no card in use: no events


def test_threads_record_into_one_recorder_with_their_own_parents():
    """Sixteen threads nest spans on one stream at a tiny switch
    interval: every span is recorded once, and each parent link stays on
    its own thread."""
    import sys
    import threading
    es, rec = EventStream(), SpanRecorder()
    es.record_spans(rec)

    def work(k):
        for i in range(200):
            with es.span("t.outer", k=k, i=i):
                with es.span("t.inner", k=k, i=i):
                    pass

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    spans = rec.spans()
    assert len(spans) == 16 * 200 * 2
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "t.inner":
            p = by_id[s.parent]
            assert p.name == "t.outer" and p.ids == s.ids
            assert p.thread == s.thread
        else:
            assert s.parent is None


@pytest.mark.parametrize("use_terra", [True, False])
def test_spans_off_build_nothing_and_record_nothing(llama, monkeypatch,
                                                    use_terra):
    built, events = [], []
    real_span, real_event = stream_mod.Span, spans_mod._timing_event

    def span(*a, **k):
        built.append(a[1])
        return real_span(*a, **k)

    def timing_event():
        events.append(1)
        return real_event()

    monkeypatch.setattr(stream_mod, "Span", span)
    monkeypatch.setattr(spans_mod, "_timing_event", timing_event)
    rec = _Counting()
    cfg, params = llama
    sch = ContinuousBatchingScheduler(cfg, params, max_slots=3, max_len=64,
                                      use_terra=use_terra, device="cpu")
    sch.events.record_spans(rec)
    sch.events.record_spans(None)
    reqs = sch.serve(requests(cfg))
    sch.close()
    assert all(r.out_tokens for r in reqs)
    assert built == [] and events == [] and rec.calls == 0


def test_spans_leave_tokens_and_the_event_stream_alone(llama, on):
    reqs, events, _ = serve(llama)
    got, on_events, _ = on
    assert [r.out_tokens for r in got] == [r.out_tokens for r in reqs]
    assert Counter(type(e).__name__ for e in on_events) == \
        Counter(type(e).__name__ for e in events)


def test_every_step_holds_its_loop_spans(on):
    _, _, spans = on
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "sched.step"]
    assert len(steps) >= 10
    kids = {s.id: [] for s in steps}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
            if p.name == "sched.step":
                assert s.name in SCHED_CHILDREN
                kids[p.id].append(s)
    for st in steps:
        names = [k.name for k in kids[st.id]]
        assert names[0] == "sched.plan", names
        assert all(k.ids.get("step") in (None, st.ids["step"],
                                         st.ids["step"] - 1)
                   for k in kids[st.id])
        assert any(n.startswith("sched.dispatch.") for n in names) or \
            "sched.fetch" in names or "sched.idle" in names
    # the engine's call runs inside the decode dispatch that made it
    for s in spans:
        if s.name == "engine.call":
            assert by_id[s.parent].name.startswith("sched.dispatch.")


def test_fetch_and_deliver_name_the_step_they_harvest(on):
    _, _, spans = on
    by_id = {s.id: s for s in spans}
    dispatched = {s.ids["step"]: s for s in spans
                  if s.name.startswith("sched.dispatch.")}
    fetches = [s for s in spans if s.name == "sched.fetch"]
    assert {f.ids["step"] for f in fetches} == set(dispatched)
    for f in fetches:
        assert dispatched[f.ids["step"]].t1_ns <= f.t0_ns
        if f.parent is not None:        # one step deep: fetched a pass later
            assert by_id[f.parent].ids["step"] == f.ids["step"] + 1
    delivered = Counter(s.ids.get("step") for s in spans
                        if s.name == "sched.deliver")
    assert all(delivered[f.ids["step"]] >= 1 for f in fetches)


def test_runner_spans_run_on_their_thread_with_their_dispatch_seq(on):
    _, events, spans = on
    main = {s.thread for s in spans if s.name == "sched.step"}
    runner = [s for s in spans if s.name.startswith("runner.")]
    assert len(main) == 1 and runner
    assert all(s.thread not in main for s in runner)
    assert {s.thread_name for s in runner} == {"terra-graphrunner"}
    seqs = [s.ids["seq"] for s in runner]
    assert len(seqs) == len(set(seqs))
    dispatched = {e.seq for e in events if isinstance(e, T.SegmentDispatch)}
    assert dispatched and dispatched == {
        s.ids["seq"] for s in runner
        if s.name in ("runner.segment", "runner.chain", "runner.steady")}


@pytest.mark.parametrize("use_terra", [True, False])
def test_prefill_spans_name_their_requests_and_prompt_tokens(llama, on,
                                                             use_terra):
    if use_terra:
        reqs, _, spans = on
    else:
        rec = SpanRecorder()
        reqs, _, _ = serve(llama, rec, use_terra=False)
        spans = rec.spans()
    pre = [s for s in spans if s.name == "step.prefill"]
    rids = [r for s in pre for r in s.ids["rids"]]
    assert sorted(rids) == sorted(r.rid for r in reqs)
    plen = {r.rid: len(r.prompt) for r in reqs}
    for s in pre:
        assert s.ids["tokens"] == sum(plen[r] for r in s.ids["rids"])
        assert s.device_ms is None          # the CPU has no device time
    dispatch = [s for s in spans if s.name == "sched.dispatch.prefill"]
    assert [d.ids["rids"] for d in dispatch] == [s.ids["rids"] for s in pre]
    if use_terra:                       # the splice runs on the runner
        by_id = {s.id: s for s in spans}
        assert any(by_id[s.parent].name == "runner.varop" for s in pre
                   if s.parent is not None)


def test_chrome_trace_draws_spans_on_their_lanes(on, tmp_path):
    _, events, spans = on
    tr = chrome_trace(events, spans)
    path = tmp_path / "t.json"
    path.write_text(json.dumps(tr))
    evs = json.loads(path.read_text())["traceEvents"]
    slices = [e for e in evs if e.get("pid") == 3 and e["ph"] == "X"]
    assert len(slices) == len(spans)
    lanes = {e["args"]["name"] for e in evs if e.get("pid") == 3
             and e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"MainThread", "terra-graphrunner", "device"} <= lanes
    step = next(e for e in slices if e["name"] == "sched.step")
    sp = next(s for s in spans if s.id == step["args"]["id"])
    assert step["dur"] == pytest.approx((sp.t1_ns - sp.t0_ns) / 1e3, abs=1.0)
    # spans and events share one base: each iteration's span covers its
    # engine.call span's start, within the two clocks' rounding
    iters = [e for e in evs if e.get("pid") == 1 and e["ph"] == "X"
             and e["name"].startswith("iter ")]
    calls = [e for e in slices if e["name"] == "engine.call"]
    assert iters and calls
    for it in iters:
        assert any(abs(c["ts"] - it["ts"]) < 2e3 for c in calls)
    # without spans the trace is what it was
    assert chrome_trace(events) == chrome_trace(events, ())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the capture spans' device times "
                    "are read on the card (README: the cuda tests)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_replays_record_their_copies_with_device_times(card):
    w = np.linspace(0.5, 1.5, 4096).astype(np.float32)

    @function(device=card)
    def step(x):
        return float(ops.reduce_sum(ops.mul(ops.add(x, 1.0), w)))

    xs = [np.random.RandomState(i).randn(64, 4096).astype(np.float32)
          for i in range(8)]
    for x in xs[:3]:                # trace, warm-up, capture
        step(x)
    step.wait()
    rec = SpanRecorder()
    step.engine.events.record_spans(rec)
    for x in xs[3:]:
        step(x)
    step.wait()
    step.engine.events.record_spans(None)
    spans = rec.spans()
    names = Counter(s.name for s in spans)
    assert names["capture.replay"] == 5 and names["engine.call"] == 5
    assert names["capture.copy_out"] == 5
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name.startswith("capture.") and s.name != "capture.record":
            assert s.device_ms is not None and s.device_ms >= 0
            assert s.device_t0_ns is not None
            assert by_id[s.parent].name == "runner.segment"
    step.close()
