"""The port's observability layer (repro_torch.obs, repro_torch.core.events
schema and processors), on the CPU, held against the JAX reference.

The ten tests of tests/test_obs.py that do not test
benchmarks/check_regression, and the request-trace, steady-state and
JSONL-schema tests of tests/test_events.py, run on the port at
``smoke_config("llama3-8b")`` with ``device="cpu"`` (the same inputs, the
same assertions).  Then one seeded served run goes through both packages
(float32, the reference's params converted): the same event types in the
same counts, the same metrics counts, each package's JSONL loads with the
other's ``load_jsonl``, and ``MetricsServer`` serves the port's registry
over loopback.
"""

import dataclasses
import json
import math
import re
import urllib.request
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import Variable, function, ops  # noqa: E402
from repro_torch.core.events import (EventStream, JsonlSink,  # noqa: E402
                                     ListProcessor, RequestTraceProcessor,
                                     dict_to_event, event_to_dict,
                                     load_jsonl, types, validate_jsonl)
from repro_torch.core.events import types as T  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.obs import (GROWTH, Histogram,  # noqa: E402
                             MetricsProcessor, MetricsRegistry,
                             TraceViewerExporter, chrome_trace,
                             counters_table)
from repro_torch.obs.http import MetricsServer  # noqa: E402
from repro_torch.obs.report import main as report_main  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,  # noqa
                                         SlotPool)

MAX_LEN = 64
LENS, MNS = [5, 8, 13, 8, 5, 16], [4, 9, 3, 5, 7, 4]


@pytest.fixture(scope="module")
def llama():
    cfg = smoke_config("llama3-8b")
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


def make_requests(cfg, lens, max_news, seed=1, R=Request, **kw):
    rng = np.random.RandomState(seed)
    return [R(prompt=rng.randint(0, cfg.vocab, L).astype(np.int32),
              max_new_tokens=mn, arrival_time=0.0, **kw)
            for L, mn in zip(lens, max_news)]


@pytest.fixture(scope="module")
def served(llama):
    """One mid-decode-admission serving run with sampled profiling,
    metrics, and the trace buffer attached — shared by the timeline,
    metrics, and equality tests below."""
    cfg, params = llama
    eng = ServingEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    ref = make_requests(cfg, LENS, MNS)
    for r in ref:
        eng.run_batch([r])
    eng.terra.close()

    sch = ContinuousBatchingScheduler(cfg, params, max_slots=3,
                                      max_len=MAX_LEN, steady_state=4,
                                      profile=3, device="cpu")
    registry = sch.enable_metrics()
    lp = ListProcessor()
    sch.events.attach(lp)
    got = make_requests(cfg, LENS, MNS)
    sch.serve(got)
    stats = sch.stats
    sch.close()
    return dict(ref=ref, got=got, events=lp.events, registry=registry,
                stats=stats)


# ==========================================================================
# sampled profiling: correctness must be untouched
# ==========================================================================

def test_profiling_preserves_token_equality_and_steady_entry(served):
    """profile=3 times segments on the GraphRunner thread only: every
    request still matches its solo lock-step decode, and the engine still
    reaches zero-walker steady state."""
    for i, (a, b) in enumerate(zip(served["ref"], served["got"])):
        assert a.out_tokens == b.out_tokens, f"request {i}"
    st = served["stats"]
    assert st["phase"] == "co-execution"
    assert st["retraces"] == 0 and st["replays"] == 0
    assert st["steady_iters"] > 0                  # steady entry happened
    profs = [e for e in served["events"] if isinstance(e, T.SegmentProfile)]
    assert profs, "profile=3 emitted no SegmentProfile events"
    for e in profs:
        assert e.kind in ("segment", "chain", "steady")
        # on the CPU the device time is the call's host wall
        assert 0.0 < e.dispatch <= e.device
    assert any(e.kind == "steady" for e in profs)  # sampling survives steady


def test_dense_pool_counts_resident_tokens(served):
    st = served["stats"]
    assert st["peak_resident_tokens"] == 3 * MAX_LEN
    pool = SlotPool(2, row_tokens=16)
    pool.alloc("r0", 5)
    assert pool.resident_tokens == 16
    pool.alloc("r1", 7)
    assert (pool.resident_tokens, pool.peak_resident_tokens) == (32, 32)
    pool.release(0)
    assert (pool.resident_tokens, pool.peak_resident_tokens) == (16, 32)


# ==========================================================================
# timeline export
# ==========================================================================

def _tracks_monotone(evs):
    by_track = {}
    for e in evs:
        assert {"ph", "pid", "tid"} <= set(e)
        if e["ph"] == "M":
            continue
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0.0
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
        by_track.setdefault((e["pid"], e["tid"]), []).append(e["ts"])
    for track, tss in by_track.items():
        assert tss == sorted(tss), f"track {track} timestamps not monotone"


def test_trace_json_valid_and_tracks_monotone(served, tmp_path):
    trace = chrome_trace(served["events"])
    doc = json.loads(json.dumps(trace))            # strict JSON
    evs = doc["traceEvents"]
    assert len(evs) > 50
    _tracks_monotone(evs)
    exp = TraceViewerExporter(str(tmp_path / "t.trace.json"))
    for e in served["events"]:
        exp.process(e)
    exp.close()
    with open(exp.path) as f:
        assert json.load(f)["traceEvents"] == evs


def _flows_complete(evs, retired):
    flows = {}
    for e in evs:
        if e.get("cat") == "flow" and str(e["id"]).startswith("req:"):
            flows.setdefault(e["id"], []).append(e["ph"])
    assert retired and set(flows) == retired
    for fid, phs in flows.items():
        assert phs[0] == "s" and phs[-1] == "f", fid
        assert phs.count("s") == 1 and phs.count("f") == 1, fid
        assert "t" in phs, fid
    assert all(e.get("bp") == "e" for e in evs
               if e.get("cat") == "flow" and e["ph"] == "f")


def test_trace_request_flows_complete(served):
    evs = chrome_trace(served["events"])["traceEvents"]
    _flows_complete(evs, {f"req:{e.rid}" for e in served["events"]
                          if isinstance(e, T.RequestRetire)})


# ==========================================================================
# streaming histograms + registry
# ==========================================================================

def test_histogram_matches_exact_rank_statistics():
    rng = np.random.RandomState(7)
    samples = rng.lognormal(mean=1.0, sigma=1.2, size=5000)
    h = Histogram()
    for v in samples:
        h.observe(float(v))
    srt = np.sort(samples)
    tol = math.sqrt(GROWTH) - 1.0 + 1e-9           # bucket guarantee
    for q in (50.0, 90.0, 95.0, 99.0):
        exact = srt[max(1, math.ceil(q / 100.0 * len(srt))) - 1]
        got = h.percentile(q)
        assert abs(got - exact) / exact <= tol, (q, got, exact)
    assert h.mean == pytest.approx(samples.mean())
    assert h.count == 5000
    assert h.percentile(0.0) == pytest.approx(srt[0], rel=tol)
    assert h.percentile(100.0) == pytest.approx(srt[-1], rel=tol)


def test_histogram_zeros_and_empty():
    h = Histogram()
    assert h.percentile(50.0) == 0.0 and h.mean == 0.0
    for v in (0.0, -1.0, 2.0, 4.0):
        h.observe(v)
    assert h.percentile(25.0) == 0.0               # underflow bucket
    assert h.count == 4 and h.mean == pytest.approx(1.25)


_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+=\"[^\"]*\"(,[a-zA-Z_]+="
    r"\"[^\"]*\")*\})? [-+0-9.eEnaif]+$")


def _prometheus_names(text, reg):
    names = set()
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            assert line.startswith(("# HELP", "# TYPE"))
            continue
        assert _PROM_LINE.match(line), line
        names.add(line.split("{")[0].split(" ")[0])
    for name, h in reg.histograms.items():
        if not h.count:
            continue
        pat = re.compile(rf'^terra_{name}_bucket{{le="([^"]+)"}} (\d+)$',
                         re.M)
        counts = [int(m.group(2)) for m in pat.finditer(text)]
        assert counts == sorted(counts)
        assert counts[-1] == h.count               # le="+Inf"
    return names


def test_prometheus_exposition_parses(served):
    reg = served["registry"]
    assert reg.histograms["ttft_ms"].count == len(served["got"])
    names = _prometheus_names(reg.prometheus_text(), reg)
    assert "terra_ttft_ms_count" in names
    assert "terra_ttft_ms_bucket" in names


def test_metrics_processor_replay_and_counters_table(served):
    mp = MetricsProcessor()
    for e in served["events"]:
        mp.process(e)
    live = served["registry"]
    for name in ("ttft_ms", "token_latency_ms", "dispatch_us",
                 "segment_device_us"):
        assert mp.registry.histograms[name].count == \
            live.histograms[name].count, name
    table = counters_table({"b_num": 3, "a_str": "x", "c_f": 1.5})
    assert "b_num" in table and "c_f" in table and "a_str" not in table


def test_metrics_registry_standalone():
    reg = MetricsRegistry()
    reg.observe("lat_ms", 3.0)
    reg.observe("lat_ms", 9.0)
    reg.set_gauge("depth", 4)
    reg.attach_counters({"steps": 12})
    snap = reg.snapshot()
    assert snap["histograms"]["lat_ms"]["count"] == 2
    assert snap["gauges"]["depth"] == 4
    assert snap["counters"]["steps"] == 12


# ==========================================================================
# fork observation
# ==========================================================================

def test_fork_observation_distribution():
    @function(device="cpu")
    def step(x):
        y = ops.mul(x, 2.0)
        if float(ops.reduce_sum(y)) > 10.0:        # gating fetch -> fork
            y = ops.mul(y, 10.0)
        else:
            y = ops.add(y, 1.0)
        return ops.reduce_sum(y)

    lp = ListProcessor()
    step.engine.events.attach(lp)
    for v in (0.5, 0.5, 3.0, 0.5, 3.0, 4.0, 0.1, 5.0):
        float(step(np.full(4, v, np.float32)))
    fam = step.engine.family
    step.close()
    obs = lp.of_type(T.ForkObserved)
    assert obs, "no ForkObserved events for a branchy program"
    assert len({e.case for e in obs}) == 2
    assert len({e.family for e in obs}) == 1
    assert len(fam.sel_dist) >= 1
    dist = next(iter(fam.sel_dist.values()))
    assert sorted(dist) == [0, 1]
    assert sum(dist.values()) == len(obs)


# ==========================================================================
# request traces, steady-state events, the JSONL schema
# (tests/test_events.py:153-260)
# ==========================================================================

def _assert_complete_trace(rec, req):
    kinds = [r["type"] for r in rec]
    assert kinds[:3] == ["RequestSubmit", "RequestAdmit", "RequestPrefill"]
    assert kinds[-1] == "RequestRetire"
    toks = [r for r in rec if r["type"] == "RequestToken"]
    assert len(toks) == len(req.out_tokens)
    assert [t["token"] for t in toks] == list(req.out_tokens)
    assert [t["index"] for t in toks] == list(range(len(toks)))
    ts = [r["ts"] for r in rec]
    assert all(a <= b for a, b in zip(ts, ts[1:])), "timestamps regress"
    return rec[-1]


def test_request_traces_mid_decode_admission(llama):
    cfg, params = llama
    sch = ContinuousBatchingScheduler(cfg, params, max_slots=3,
                                      max_len=MAX_LEN, device="cpu")
    tracer = sch.events.attach(RequestTraceProcessor())
    reqs = sch.serve(make_requests(cfg, LENS, MNS))
    assert sch.stats["retired"] == len(reqs)
    assert len(tracer.traces) == len(reqs)
    for req in reqs:
        retire = _assert_complete_trace(tracer.trace(req.rid), req)
        assert retire["reason"] == "budget"
        assert retire["tokens"] == len(req.out_tokens)
    sch.close()


def test_request_trace_eos_retirement(llama):
    cfg, params = llama
    sch = ContinuousBatchingScheduler(cfg, params, max_slots=2,
                                      max_len=MAX_LEN, device="cpu")
    [probe] = sch.serve(make_requests(cfg, [6], [8]))
    idx, eos = next((i, t) for i, t in enumerate(probe.out_tokens)
                    if i > 0 and t not in probe.out_tokens[:i])
    tracer = sch.events.attach(RequestTraceProcessor())
    [req] = sch.serve(make_requests(cfg, [6], [8], eos_id=eos))
    assert req.done and len(req.out_tokens) == idx + 1
    retire = _assert_complete_trace(tracer.trace(req.rid), req)
    assert retire["reason"] == "eos" and retire["tokens"] == idx + 1
    sch.close()


def test_steady_state_events():
    v = Variable(np.zeros(4, np.float32))

    @function(optimize="safe", steady_state=2, steady_probe=4, device="cpu")
    def step(x):
        y = ops.mul(x, 2.0)
        v.assign(ops.add(v.read(), y))
        return y

    lp = step.engine.events.attach(ListProcessor())
    for i in range(16):
        np.asarray(step(np.full(4, float(i + 1), np.float32)).numpy())
    step.wait()
    assert step.stats["steady_iters"] > 0
    assert len(lp.of_type(types.SteadyEnter)) == step.stats["steady_entries"]
    steady_dispatch = [e for e in lp.of_type(types.SegmentDispatch)
                       if e.kind == "steady"]
    assert len(steady_dispatch) == step.stats["steady_iters"]
    assert len(lp.of_type(types.SteadyProbe)) >= 1
    step.close()


def test_event_dict_roundtrip():
    for e in (types.IterationStart(3, "skeleton", "a1b2c3d4"),
              types.Divergence(7, "const mismatch"),
              types.RequestToken(2, 991, 0),
              types.PassPipelineRun(4, "f" * 8, ("cse", "dce"),
                                    {"cse": {"cse_hits": 2}})):
        d = json.loads(json.dumps(event_to_dict(e)))
        e2 = dict_to_event(d)
        assert type(e2) is type(e)
        assert event_to_dict(e2) == event_to_dict(e)


def test_schema_rejects_malformed():
    with pytest.raises(ValueError, match="unknown event type"):
        dict_to_event({"type": "NoSuchEvent"})
    with pytest.raises(ValueError):                      # extra field
        dict_to_event({"type": "Transition", "iter_id": 1, "bogus": 2})
    with pytest.raises(ValueError):                      # missing field
        dict_to_event({"type": "RequestToken", "rid": 1})


def test_jsonl_sink_and_validation(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    es = EventStream()
    es.attach(JsonlSink(path))
    es.emit(types.IterationStart(0, "tracing", "00000000"))
    es.emit(types.RequestSubmit(1, 8, 4))
    es.emit(types.RequestRetire(1, "eos", 3))
    es.close()                          # close flushes the sink
    events = load_jsonl(path)
    assert [type(e).__name__ for e in events] == \
        ["IterationStart", "RequestSubmit", "RequestRetire"]
    assert events[0].ts is not None
    assert validate_jsonl(path) == {"IterationStart": 1, "RequestSubmit": 1,
                                    "RequestRetire": 1}
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "NoSuchEvent"}\n')
    with pytest.raises(ValueError, match="bad.jsonl:1"):
        validate_jsonl(str(bad))


def test_report_cli_writes_segment_table_and_timeline(served, tmp_path,
                                                      capsys):
    """``python -m repro_torch.obs.report``: the served run's JSONL gives
    a segment table with sampled device times, and a ``.trace.json`` with
    monotone tracks and complete request flows."""
    path = str(tmp_path / "served.jsonl")
    sink = JsonlSink(path)
    for e in served["events"]:
        sink.process(e)
    sink.close()
    assert report_main([path]) == 0
    out = capsys.readouterr().out
    assert "per-segment host/device time" in out and "steady[0]" in out
    assert "serving metrics" in out
    with open(path + ".trace.json") as f:
        evs = json.load(f)["traceEvents"]
    _tracks_monotone(evs)
    _flows_complete(evs, {f"req:{e.rid}" for e in served["events"]
                          if isinstance(e, T.RequestRetire)})


# ==========================================================================
# one seeded served run through both packages
# ==========================================================================

TIMING_FIELDS = ("dispatch", "device", "dur", "wait", "wall", "stall",
                 "queued_s")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The same float32 params (the reference's, converted), the same
    requests, profile=3, metrics and a JSONL sink on each package's
    scheduler."""
    import jax
    from repro.configs import smoke_config as j_smoke
    from repro.core.events import JsonlSink as JSink
    from repro.core.events import ListProcessor as JList
    from repro.models import model as JM
    from repro.serve.engine import Request as JRequest
    from repro.serve.scheduler import ContinuousBatchingScheduler as JSched
    from repro_torch.models.convert import params_from_jax

    d = tmp_path_factory.mktemp("both")
    f32 = dict(dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), **f32)
    tcfg = dataclasses.replace(smoke_config("llama3-8b"), **f32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(max_slots=3, max_len=MAX_LEN, steady_state=4, profile=3,
              page_size=16)
    out = {}
    for name, sched, cfg, p, R, lst, sink, extra in (
            ("ref", JSched, jcfg, jp, JRequest, JList, JSink, {}),
            ("port", ContinuousBatchingScheduler, tcfg, tp, Request,
             ListProcessor, JsonlSink, {"device": "cpu"})):
        sch = sched(cfg, p, **kw, **extra)
        reg = sch.enable_metrics()
        lp = sch.events.attach(lst())
        path = str(d / f"{name}.jsonl")
        sch.events.attach(sink(path))
        reqs = sch.serve(make_requests(cfg, LENS, MNS, R=R))
        sch.close()                     # closes the stream: flushes the sink
        out[name] = dict(events=lp.events, registry=reg, jsonl=path,
                         tokens=[r.out_tokens for r in reqs])
    return out


def test_both_packages_emit_the_same_events(both):
    ref, port = both["ref"], both["port"]
    assert port["tokens"] == ref["tokens"]
    assert Counter(type(e).__name__ for e in port["events"]) == \
        Counter(type(e).__name__ for e in ref["events"])

    def untimed(events):
        from repro.core.events import event_to_dict as j_to_dict
        return [{k: v for k, v in (
            event_to_dict(e) if type(e).__module__.startswith("repro_torch")
            else j_to_dict(e)).items()
            if k not in ("ts",) + TIMING_FIELDS}
            for e in events if type(e).__name__.startswith("Request")]
    assert untimed(port["events"]) == untimed(ref["events"])


def test_both_packages_count_the_same_metrics(both):
    def counts(reg):
        snap = reg.snapshot()
        # counters: the integer ones (the float ones are host times)
        return ({k: h["count"] for k, h in snap["histograms"].items()},
                {k: v for k, v in snap["counters"].items()
                 if isinstance(v, int)})
    assert counts(both["port"]["registry"]) == counts(both["ref"]["registry"])


def test_jsonl_crosses_between_the_packages(both):
    from repro.core.events import event_to_dict as j_to_dict
    from repro.core.events import load_jsonl as j_load
    for name in ("ref", "port"):
        path = both[name]["jsonl"]
        mine, theirs = load_jsonl(path), j_load(path)
        assert [type(e).__name__ for e in mine] == \
            [type(e).__name__ for e in theirs]
        assert [event_to_dict(e) for e in mine] == \
            [j_to_dict(e) for e in theirs]
        assert len(mine) == len(both[name]["events"])
    assert Counter(type(e).__name__ for e in
                   load_jsonl(both["ref"]["jsonl"])) == \
        Counter(type(e).__name__ for e in load_jsonl(both["port"]["jsonl"]))


def test_metrics_server_serves_prometheus_over_loopback(both):
    reg = both["port"]["registry"]
    srv = MetricsServer(reg)
    try:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        with urllib.request.urlopen(srv.url + "/metrics.json",
                                    timeout=10) as r:
            snap = json.loads(r.read().decode())
    finally:
        srv.stop()
    assert srv.url.startswith("http://127.0.0.1:")
    names = _prometheus_names(text, reg)
    assert "terra_ttft_ms_count" in names
    assert snap["histograms"]["ttft_ms"]["count"] == len(LENS)
