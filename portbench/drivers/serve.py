"""The serving driver: the port's ``ContinuousBatchingScheduler`` fed an
open loop of requests made from the seed.

Set-up makes the weights, builds the scheduler as the mix's
``scheduler`` block says, and warms up every shape the mix's traffic
uses: each prefill length bucket at each padded group size up to the
admission cap, and the captured decode step.  The window submits the
requests (``core/traffic.py``), each due at its scheduled arrival, and
runs the scheduler until it has drained them; arrivals stop at the end of
``seconds`` and the requests in flight drain inside the timed span.  A
per-token stream callback stamps every token: time to first token is
timed from the request's scheduled arrival, the gaps between tokens from
the stamps.  Once the window has closed and the scheduler is freed, the
plain reference runs over a sample (drawn from the seed, the longest
request in it) of the finished requests' prompts and served tokens, and
the gaps by which served tokens' logits lie below the reference's best
are compared with the cell's limits (``limits/<cell>.json`` names which:
``gaps``).

Mix keys: ``scheduler`` (the scheduler's arguments), ``rate``, ``prompt``
and ``output`` (distributions, see ``core/traffic.py``),
``sample_tokens`` (served tokens the check covers at least),
``traced_kernels``, ``trace_window`` ([seconds in, seconds long]: the
span a traced run profiles), ``control_seconds`` (the control's window)."""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np

from portbench.core import devtrace, manifest, stats, traffic
from portbench.core import weights as W
from portbench.core.runner import Outcome
from portbench.roofline import kernels as KN

SCHED_COUNTERS = ("admitted", "retired", "decode_steps", "prefill_steps",
                  "prefill_tokens", "generated_tokens", "step_dispatch_time",
                  "harvest_wait_time")


def build(cell, seed: int, device: str):
    """(cfg, weights [(path, tensor)], scheduler) for ``cell``."""
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    cfg = W.model_config(cell.config)
    params, w = W.make_params(cfg, seed, device)
    kw = dict(cell.traffic["scheduler"])
    if isinstance(kw.get("optimize"), list):
        kw["optimize"] = tuple(kw["optimize"])
    sched = ContinuousBatchingScheduler(cfg, params, device=device, **kw)
    return cfg, w, sched


def counters(sched) -> dict:
    from repro_torch.kernels import ops as kops
    st = sched.stats
    out = {k: st[k] for k in SCHED_COUNTERS}
    eng = sched._tf.engine
    cap = eng.capture.stats if eng.capture is not None else {}
    out.update({"capture." + k: v for k, v in cap.items()})
    out.update({k: st.get(k, 0) for k in KN.COMPILE_COUNTERS
                if not k.startswith("capture.")})
    out.update({"launch." + k: getattr(kops, k).launches
                for k in KN.WRAPPERS})
    return out


def warm_up(sched, cfg, mix: dict, seed: int, seconds: float,
            log=None) -> None:
    """Run every prefill shape the mix's traffic uses (each length bucket
    at each padded group size up to the cap) and enough decode steps for
    the decode step to be captured and replayed."""
    from repro_torch.core.executor.families import bucket_pow2
    from repro_torch.serve.engine import Request
    from repro_torch.serve.scheduler.lifecycle import bucket_len
    kw = mix["scheduler"]
    max_len = kw["max_len"]
    cap = min(kw.get("prefill_batch_cap") or kw["max_slots"],
              kw["max_slots"])
    lens = sorted({len(it.prompt) for it in
                   traffic.requests(mix, seed, seconds, cfg.vocab)})
    buckets = {}
    for L in lens:
        buckets.setdefault(bucket_len(cfg, L, max_len), L)
    groups = sorted({bucket_pow2(b) for b in range(1, cap + 1)})
    rng = np.random.default_rng([int(seed), 11])
    first = True
    for bucket, L in sorted(buckets.items()):
        for g in groups:
            new = 24 if first else 2
            first = False
            sched.serve([Request(prompt=rng.integers(0, cfg.vocab, L,
                                                     dtype=np.int32),
                                 max_new_tokens=new, arrival_time=0.0)
                         for _ in range(g)])
            if log is not None:
                log(bucket, g)


class _Admits:
    """Collects the queueing delay of every admission (``RequestAdmit``)
    while the tracer runs."""

    def __init__(self, tracer):
        self.tracer, self.waits = tracer, []

    def process(self, event):
        if self.tracer.active and type(event).__name__ == "RequestAdmit":
            self.waits.append(event.queued_s)

    def close(self):
        pass


def _spanned(tracer, name, fn):
    def call(*a, **k):
        with tracer.span(name):
            return fn(*a, **k)
    return call


def window(sched, cfg, mix: dict, seed: int, seconds: float, tracer,
           rate: float = None):
    """Serve the window's requests.  Returns (requests, their stamps,
    scheduled arrivals, counters before, the counters' growth over the
    traced span, each traced decode step's valid lengths, admission
    waits in the traced span)."""
    import torch
    from repro_torch.serve.engine import Request
    items = traffic.requests(mix, seed, seconds, cfg.vocab, rate)
    stamps = {}

    def stream(req, token, index):
        stamps[req.rid].append(time.perf_counter())

    valid, admits, marks = [], _Admits(tracer), []
    if tracer.on:
        sched.events.attach(admits)

        def settle():
            # the steps dispatched so far run before the edge, so the
            # counters and the trace cover the same launches
            sched._tf.wait()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            marks.append(counters(sched))
        tracer.on_edge = settle
        decode, harvest = sched._dispatch_decode, sched._harvest

        def dispatch_decode(plan):
            if tracer.active:
                valid.append((sched.pool.pos[plan.mask] + 1).tolist())
            return decode(plan)

        def harvest_step(entry):
            tracer.tick()
            return harvest(entry)

        sched._dispatch_decode = _spanned(tracer, "decode_dispatch",
                                          dispatch_decode)
        sched._dispatch_prefill = _spanned(tracer, "prefill_dispatch",
                                           sched._dispatch_prefill)
        sched._harvest = _spanned(tracer, "harvest", harvest_step)
        sched._idle = _spanned(tracer, "idle", sched._idle)
    before = counters(sched)
    with tracer:
        t0 = time.perf_counter()
        reqs = []
        for it in items:
            r = Request(prompt=it.prompt, max_new_tokens=it.max_new_tokens,
                        arrival_time=t0 + it.arrival, stream=stream)
            sched.submit(r)
            stamps[r.rid] = []
            reqs.append(r)
        sched.run()
    if tracer.on:
        sched.events.detach(admits)
        for name in ("_dispatch_decode", "_dispatch_prefill", "_harvest",
                     "_idle"):
            delattr(sched, name)
    traced = ({k: marks[1][k] - marks[0][k] for k in marks[0]}
              if len(marks) == 2 else None)
    arrivals = [t0 + it.arrival for it in items]
    return reqs, stamps, arrivals, before, traced, valid, admits.waits


def latencies(reqs, stamps, arrivals):
    """(generated tokens, last stamp, time-to-first-token of every request
    (infinite for one that produced nothing), every gap between
    consecutive tokens, failed requests)."""
    ttft, itl, failed, tokens, last = [], [], 0, 0, None
    for r, a in zip(reqs, arrivals):
        s = stamps[r.rid]
        tokens += len(s)
        if len(s) < r.max_new_tokens:
            failed += 1
        ttft.append(s[0] - a if s else math.inf)
        itl += [y - x for x, y in zip(s, s[1:])]
        if s:
            last = s[-1] if last is None else max(last, s[-1])
    return tokens, last, ttft, itl, failed


def sample(reqs, seed: int, want: int):
    """Finished requests to check: the one with the most served tokens,
    then others drawn from the seed until ``want`` tokens are covered."""
    done = [r for r in reqs if r.out_tokens
            and len(r.out_tokens) == r.max_new_tokens]
    if not done:
        return []
    done.sort(key=lambda r: -len(r.out_tokens))
    pick, n = [done[0]], len(done[0].out_tokens)
    rng = np.random.default_rng([int(seed), 13])
    for i in rng.permutation(len(done) - 1) + 1:
        if n >= want:
            break
        pick.append(done[i])
        n += len(done[i].out_tokens)
    return pick


def judge(cell, w, picked, device: str, precs=("f32",)):
    """Each precision's reference logits at the served positions of the
    picked requests: [(prompt length, served tokens, {prec: logits})]."""
    import torch
    ref = manifest.reference(cell.config["reference"])
    seqs = [torch.from_numpy(np.concatenate(
        [r.prompt, np.asarray(r.out_tokens[:-1], np.int32)])).to(device)
        for r in picked]
    out = [(len(r.prompt), np.asarray(r.out_tokens), {}) for r in picked]
    with torch.no_grad():
        for prec in precs:
            for o, lg in zip(out, ref.logits(dict(w), cell.config, seqs,
                                             prec)):
                o[2][prec] = lg[o[0] - 1:].float()
    return out


def gaps(judged, tokens_of) -> dict:
    """How far below the reference's best logit the token that
    ``tokens_of(served, logits)`` gives lies, over every served position
    of the judged requests: the widest gap, the mean gap, the 99th
    percentile, and the share of positions where it is not the
    reference's first token."""
    import torch
    allg = []
    for L, served, lg in judged:
        ref = lg["f32"]
        tok = torch.as_tensor(tokens_of(served, lg), device=ref.device)
        allg.append(ref.max(-1).values
                    - ref.gather(1, tok.long()[:, None])[:, 0])
    if not allg:
        return {k: math.inf for k in ("widest_gap", "mean_gap", "p99_gap",
                                      "mismatch_share")}
    g = torch.cat(allg).double()
    return {"widest_gap": float(g.max()), "mean_gap": float(g.mean()),
            "p99_gap": stats.percentile(g.tolist(), 99),
            "mismatch_share": float((g > 0).double().mean())}


def release(sched) -> None:
    import torch
    sched.close()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(spec) -> Outcome:
    import torch
    mix, dev = spec.cell.traffic, spec.device
    tracer = devtrace.Tracer(spec.trace, sub=mix.get("trace_window"))
    cfg, w, sched = build(spec.cell, spec.seed, dev)
    warm_up(sched, cfg, mix, spec.seed, spec.seconds)
    if dev == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - spec.t0

    reqs, stamps, arrivals, before, traced, valid, waits = window(
        sched, cfg, mix, spec.seed, spec.seconds, tracer)
    after = counters(sched)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    delta = {k: after[k] - before.get(k, 0) for k in after}
    _, _, ttft, itl, failed = latencies(reqs, stamps, arrivals)
    print("latency " + " ".join(
        f"{name}_p{q}_ms {1e3 * stats.percentile(xs, q)!r}"
        for name, xs in (("ttft", ttft), ("itl", itl))
        for q in (50, 90, 95, 99)), file=sys.stderr)
    ctx = {"kind": "serve", "config": spec.cell.config, "traffic": mix,
           "delta": delta, "traced": traced, "trace": tracer.trace,
           "decode_valid": valid,
           "admit_waits": waits,
           "compiled_in_window": {k: delta[k] for k in KN.COMPILE_COUNTERS
                                  if delta.get(k)}}
    if tracer.trace is not None:
        KN.check_counts(tracer.trace, traced, mix.get("traced_kernels", ()))

    picked = sample(reqs, spec.seed, mix["sample_tokens"])
    release(sched)
    del sched
    judged = judge(spec.cell, w, picked, dev)
    got = gaps(judged, lambda served, lg: served)
    print("gaps " + " ".join(f"{k} {v!r}" for k, v in got.items())
          + f" served_tokens {sum(len(j[1]) for j in judged)}",
          file=sys.stderr)
    return Outcome(
        attempted=len(reqs), failed=failed,
        end_to_end={"ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
                    "itl_p50_ms": 1e3 * stats.percentile(itl, 50),
                    "itl_p99_ms": 1e3 * stats.percentile(itl, 99),
                    "setup_s": setup_s},
        checks=[(k, got[k], lim) for k, lim in spec.cell.limits.items()],
        memory_peak_bytes=peak, ctx=ctx, trace=tracer.trace)


def control(cell, seed: int, device: str, seconds: float = None) -> dict:
    """The program's widest gap and the control's at the cell's load: a
    short window (``control_seconds``), then the float32 reference and the
    fp8 one over the same sample.  The control's reading is the widest
    gap of the token the fp8 reference puts first at each position; the
    fault of a token altered where it is produced (the next id) is read
    from the same logits."""
    import torch
    mix = cell.traffic
    seconds = seconds or mix["control_seconds"]
    cfg, w, sched = build(cell, seed, device)
    warm_up(sched, cfg, mix, seed, seconds)
    tracer = devtrace.Tracer(False)
    reqs, stamps, arrivals, *_ = window(sched, cfg, mix, seed, seconds,
                                        tracer)
    tokens, last, ttft, itl, failed = latencies(reqs, stamps, arrivals)
    picked = sample(reqs, seed, mix["sample_tokens"])
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    release(sched)
    del sched
    judged = judge(cell, w, picked, device, ("f32", "fp8"))
    V = cfg.vocab
    return {
        "served_tokens": int(sum(len(j[1]) for j in judged)),
        "failed": failed, "memory_peak_bytes": int(peak),
        "program": gaps(judged, lambda s, lg: s),
        "fp8": gaps(judged, lambda s, lg: lg["fp8"].argmax(-1)),
        "token_altered": gaps(judged, lambda s, lg: (s + 1) % V),
    }
