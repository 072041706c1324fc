"""Lock-step serving (``ServingEngine``) and the slot-pooled scheduler on
the new families, the port against the JAX reference, on the CPU.

Same params (the reference's, converted), same requests, float32 smoke
configs.  ``ServingEngine`` with ``use_terra`` on and off must give the
reference's greedy tokens and lock-step counters, and its co-executed
decoder the reference's engine counters (tests/test_system.py:50-53 serves
llama3-8b, recurrentgemma-2b and mixtral-8x22b through it; mamba2 is the
recurrent case).  A batch-size change on a live engine re-traces and keeps
the tokens.  The run_batch satellites of tests/test_scheduler.py:254-290
hold as they do there.  The continuous-batching scheduler serves the MoE
and hybrid families with the reference scheduler's tokens and counters,
and its per-request tokens equal the lock-step oracle's
(tests/test_scheduler.py:34-41).  The side-input families:
llama-3.2-vision-90b's ``run_batch`` with ``cross_states`` equals the
reference's; whisper-small's with ``frontend_embeds`` equals the
reference's model-level loop (prefill, then decode with the encoder
states), which the reference's own ``run_batch`` leaves after the first
token (ROADMAP.md Queue 3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JScheduler  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serve.scheduler import \
    ContinuousBatchingScheduler  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
MAX_LEN = 64
LOCKSTEP_KEYS = ("prefill_tokens", "decode_steps")
ENGINE_KEYS = ("phase", "retraces", "replays", "graph_versions", "families",
               "iterations", "traced_iterations", "segments_dispatched",
               "segments_recompiled")
KERNELS = ("cse", "kernels", "dce", "coalesce")
SCHED_KEYS = ("decode_steps", "prefill_steps", "admitted", "retired",
              "generated_tokens", "prefill_tokens", "idle_waits")
_MODELS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def model(arch):
    """(jcfg, tcfg, reference params, port params) of a float32 smoke
    config, made once per process.  A VLM's cross gates (zero at init,
    which would hide the vision states) get seeded non-zero values."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(j_smoke(arch), **F32)
        tcfg = dataclasses.replace(t_smoke(arch), **F32)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        rng = np.random.RandomState(3)
        jp["blocks"] = [
            {**b, "gate": jnp.asarray(rng.uniform(0.3, 1.0, b["gate"].shape),
                                      b["gate"].dtype)}
            if kind == "cross" else b
            for b, kind in zip(jp["blocks"], jcfg.block_pattern)]
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[arch] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch]


def make_requests(R, vocab, lens, max_news, seed=1, **kw):
    rng = np.random.RandomState(seed)
    return [R(prompt=rng.randint(0, vocab, L).astype(np.int32),
              max_new_tokens=mn, arrival_time=0.0, **kw)
            for L, mn in zip(lens, max_news)]


def run_batches(eng, R, vocab, batches):
    """Serve each (lens, max_news) batch through ``eng.run_batch``."""
    out = []
    for i, (lens, mns) in enumerate(batches):
        reqs = make_requests(R, vocab, lens, mns, seed=i)
        eng.run_batch(reqs)
        out.append([r.out_tokens for r in reqs])
    return out


# two batches of four, then one of two: the batch-size change re-traces
BATCHES = [([16] * 4, [8, 6, 8, 3]), ([16] * 4, [5, 8, 8, 8]),
           ([12] * 2, [6, 4])]


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m",
                                  "mixtral-8x22b", "recurrentgemma-2b"])
def test_serving_engine_matches_reference(arch):
    jcfg, tcfg, jp, tp = model(arch)
    jeng = JEngine(jcfg, jp, max_len=MAX_LEN)
    want = run_batches(jeng, JRequest, jcfg.vocab, BATCHES)
    jst = dict(jeng.terra.stats)
    jeng.terra.close()
    got = {}
    for use_terra in (True, False):
        eng = ServingEngine(tcfg, tp, max_len=MAX_LEN, use_terra=use_terra,
                            device="cpu")
        got[use_terra] = run_batches(eng, Request, tcfg.vocab, BATCHES)
        assert {k: eng.stats[k] for k in LOCKSTEP_KEYS} == \
            {k: jeng.stats[k] for k in LOCKSTEP_KEYS}
        if use_terra:
            tst = dict(eng.terra.stats)
            assert eng.terra.phase == "co-execution"
            assert {k: tst.get(k) for k in ENGINE_KEYS} == \
                {k: jst.get(k) for k in ENGINE_KEYS}
            # batch 4 -> 2: a second graph family, traced once
            assert tst["graph_versions"] >= 2 and tst["retraces"] >= 1
        eng.close()
    assert got[True] == want                      # greedy tokens identical
    assert got[False] == want


def test_batch_size_change_retraces_and_keeps_tokens():
    """The same engine serves batch sizes 4, 2, 4: the first change
    traces a new family (graph_versions bumps), the return to 4 selects
    the known one (no further retrace), tokens equal a use_terra=False
    engine's throughout."""
    _, tcfg, _, tp = model("llama3-8b")
    batches = [BATCHES[0], BATCHES[2], BATCHES[1]]
    eng = ServingEngine(tcfg, tp, max_len=MAX_LEN, device="cpu")
    base = ServingEngine(tcfg, tp, max_len=MAX_LEN, use_terra=False,
                         device="cpu")
    versions = []
    for i, b in enumerate(batches):
        got = run_batches(eng, Request, tcfg.vocab, [b])
        want = run_batches(base, Request, tcfg.vocab, [b])
        assert got == want
        versions.append(eng.terra.stats["graph_versions"])
        if i == 1:
            retraces = eng.terra.stats["retraces"]
    assert versions[1] > versions[0]
    assert eng.terra.stats["retraces"] == retraces
    eng.close()


def test_run_batch_rejects_ragged_prompts_and_side_inputs():
    """Ragged prompts and unknown arguments raise; the side inputs are
    taken, and a model with no cross-attention or encoder ignores them,
    as the reference's engine does (same tokens as without them)."""
    jcfg, tcfg, jp, tp = model("llama3-8b")
    eng = ServingEngine(tcfg, tp, max_len=MAX_LEN, use_terra=False,
                        device="cpu")
    with pytest.raises(ValueError, match="same-length"):
        eng.run_batch(make_requests(Request, tcfg.vocab, [8, 5], [4, 4]))
    with pytest.raises(TypeError, match="unexpected"):
        eng.run_batch(make_requests(Request, tcfg.vocab, [8], [4]),
                      images=np.zeros((1, 4, tcfg.d_model), np.float32))
    plain = make_requests(Request, tcfg.vocab, [8], [4])
    eng.run_batch(plain)
    jeng = JEngine(jcfg, jp, max_len=MAX_LEN, use_terra=False)
    for kw in ("cross_states", "frontend_embeds"):
        side = np.random.RandomState(2).randn(1, 4, tcfg.d_model) \
            .astype(np.float32)
        reqs = make_requests(Request, tcfg.vocab, [8], [4])
        eng.run_batch(reqs, **{kw: side})
        jreqs = make_requests(JRequest, jcfg.vocab, [8], [4])
        jeng.run_batch(jreqs, **{kw: jnp.asarray(side)})
        assert reqs[0].out_tokens == jreqs[0].out_tokens \
            == plain[0].out_tokens
    eng.close()


# --------------------------------------------------------------------------
# the side-input families: llama-3.2-vision-90b and whisper-small
# --------------------------------------------------------------------------

SIDE_BATCHES = [([12] * 3, [6, 4, 6]), ([12] * 3, [5, 6, 3])]


def side_states(cfg, batch, seed):
    """Seeded vision states or frame embeddings [batch, T, d] (f32)."""
    return np.random.RandomState(50 + seed).randn(
        batch, cfg.frontend_tokens, cfg.d_model).astype(np.float32)


def serve_with_side(eng, R, cfg, kw, wrap=np.asarray):
    """SIDE_BATCHES through ``eng.run_batch`` with seeded side inputs."""
    out = []
    for i, (lens, mns) in enumerate(SIDE_BATCHES):
        reqs = make_requests(R, cfg.vocab, lens, mns, seed=i)
        eng.run_batch(reqs, **{kw: wrap(side_states(cfg, len(lens), i))})
        out.append([r.out_tokens for r in reqs])
    return out


def whisper_model_level(jcfg, jp):
    """The reference's model-level path for SIDE_BATCHES
    (tests/test_smoke_archs.py:75-80): ``prefill(frontend_embeds=...)``,
    then ``decode_step(cross_states=encode(...))`` each step; each row
    cut at its own budget."""
    out = []
    for i, (lens, mns) in enumerate(SIDE_BATCHES):
        reqs = make_requests(JRequest, jcfg.vocab, lens, mns, seed=i)
        prompts = jnp.asarray(np.stack([r.prompt for r in reqs]))
        fe = jnp.asarray(side_states(jcfg, len(lens), i))
        logits, cache = JM.prefill(jcfg, jp, prompts, MAX_LEN,
                                   frontend_embeds=fe)
        states = JT.encode(jcfg, jp, fe)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks = [np.asarray(tok)]
        for _ in range(max(mns) - 1):
            logits, cache = JM.decode_step(jcfg, jp, cache, tok[:, None],
                                           cross_states=states)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
        rows = np.stack(toks, 1)
        out.append([rows[b, :m].tolist() for b, m in enumerate(mns)])
    return out


@pytest.mark.parametrize("use_terra", [True, False])
def test_vlm_run_batch_matches_reference(use_terra):
    """``cross_states`` feed prefill and every decode step: tokens,
    lock-step counters and (co-executed) engine counters equal the
    reference's ``run_batch``."""
    arch = "llama-3.2-vision-90b"
    jcfg, tcfg, jp, tp = model(arch)
    jeng = JEngine(jcfg, jp, max_len=MAX_LEN, use_terra=use_terra)
    want = serve_with_side(jeng, JRequest, jcfg, "cross_states", jnp.asarray)
    eng = ServingEngine(tcfg, tp, max_len=MAX_LEN, use_terra=use_terra,
                        device="cpu")
    got = serve_with_side(eng, Request, tcfg, "cross_states")
    assert got == want
    assert {k: eng.stats[k] for k in LOCKSTEP_KEYS} == \
        {k: jeng.stats[k] for k in LOCKSTEP_KEYS}
    if use_terra:
        assert eng.terra.phase == "co-execution"
        assert {k: eng.terra.stats.get(k) for k in ENGINE_KEYS} == \
            {k: jeng.terra.stats.get(k) for k in ENGINE_KEYS}
        jeng.terra.close()
    eng.close()
    # the states reach the tokens
    eng = ServingEngine(tcfg, tp, max_len=MAX_LEN, use_terra=use_terra,
                        device="cpu")
    half = serve_with_side(eng, Request, tcfg, "cross_states",
                           lambda a: a * 0.25)
    eng.close()
    assert half != got


@pytest.mark.parametrize("use_terra", [True, False])
def test_whisper_run_batch_matches_model_level_loop(use_terra):
    """``frontend_embeds`` are encoded once a batch and the encoder
    states feed prefill and every decode step: the tokens equal the
    reference's model-level loop, and the lock-step counters its
    ``run_batch``'s."""
    jcfg, tcfg, jp, tp = model("whisper-small")
    want = whisper_model_level(jcfg, jp)
    eng = ServingEngine(tcfg, tp, max_len=MAX_LEN, use_terra=use_terra,
                        device="cpu")
    got = serve_with_side(eng, Request, tcfg, "frontend_embeds")
    assert got == want
    jeng = JEngine(jcfg, jp, max_len=MAX_LEN, use_terra=False)
    serve_with_side(jeng, JRequest, jcfg, "frontend_embeds", jnp.asarray)
    assert {k: eng.stats[k] for k in LOCKSTEP_KEYS} == \
        {k: jeng.stats[k] for k in LOCKSTEP_KEYS}
    if use_terra:
        assert eng.terra.phase == "co-execution"
    eng.close()


def test_reference_whisper_run_batch_drops_the_audio_after_the_first_token():
    """The reference's ``run_batch`` decodes with ``cross_states=None``
    (src/repro/serve/engine.py:123-124, 146-149), so its decoder's cross
    attention attends over the new token: its tokens agree with the
    model-level loop at the first token only.  Pinned so that the port's
    deliberate difference stays visible."""
    jcfg, _, jp, _ = model("whisper-small")
    want = whisper_model_level(jcfg, jp)
    for use_terra in (True, False):
        jeng = JEngine(jcfg, jp, max_len=MAX_LEN, use_terra=use_terra)
        ref = serve_with_side(jeng, JRequest, jcfg, "frontend_embeds",
                              jnp.asarray)
        if use_terra:
            jeng.terra.close()
        for batch_ref, batch_want in zip(ref, want):
            assert [r[0] for r in batch_ref] == [r[0] for r in batch_want]
            assert batch_ref != batch_want


@pytest.mark.parametrize("use_terra", [False, True])
def test_run_batch_budget_tracks_live_rows_and_records_latency(use_terra):
    """tests/test_scheduler.py:266: a retired row and the pad row never
    stretch the loop; latency fields filled; finish stamped at the
    retiring step."""
    jcfg, tcfg, jp, tp = model("llama3-8b")
    jeng = JEngine(jcfg, jp, max_len=MAX_LEN, use_terra=False,
                   bucket_batches=True)
    jreqs = make_requests(JRequest, jcfg.vocab, [8, 8, 8], [2, 6, 6])
    jeng.run_batch(jreqs)
    eng = ServingEngine(tcfg, tp, max_len=MAX_LEN, use_terra=use_terra,
                        bucket_batches=True, device="cpu")
    reqs = make_requests(Request, tcfg.vocab, [8, 8, 8], [2, 6, 6])
    eng.run_batch(reqs)                               # pads batch to 4
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert [len(r.out_tokens) for r in reqs] == [2, 6, 6]
    assert eng.stats["decode_steps"] == 5 == jeng.stats["decode_steps"]
    assert eng.stats["prefill_tokens"] == 24          # real rows only
    for r in reqs:
        assert r.arrival_time <= r.first_token_time <= r.finish_time
    assert reqs[0].finish_time < reqs[1].finish_time
    eng.close()


def test_run_batch_streaming_callbacks():
    _, tcfg, _, tp = model("llama3-8b")
    got = []
    eng = ServingEngine(tcfg, tp, max_len=MAX_LEN, device="cpu")
    reqs = make_requests(Request, tcfg.vocab, [8, 8], [3, 4],
                         stream=lambda r, t, i: got.append((id(r), t, i)))
    eng.run_batch(reqs)
    for r in reqs:
        mine = [(t, i) for rid, t, i in got if rid == id(r)]
        assert mine == list(zip(r.out_tokens, range(len(r.out_tokens))))
    eng.close()


# the scheduler on the new families: two slots, admissions mid-decode
# (lengths at exact length for the hybrid, padded buckets for MoE)
SCHED_MIX = dict(lens=[5, 9, 13, 6], mns=[4, 6, 3, 5])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b",
                                  "recurrentgemma-2b"])
def test_scheduler_matches_reference_and_lockstep_oracle(arch):
    jcfg, tcfg, jp, tp = model(arch)
    lens, mns = SCHED_MIX["lens"], SCHED_MIX["mns"]
    # paged, with the kernels pass: decode runs kernel.slot_decode_paged
    # (the paged kernel's plain version on the CPU)
    m = dict(max_slots=2, max_len=MAX_LEN, page_size=8, optimize=KERNELS)
    jreqs = make_requests(JRequest, jcfg.vocab, lens, mns)
    jsched = JScheduler(jcfg, jp, **m)
    jsched.serve(jreqs)
    jst = jsched.stats
    jsched.close()
    reqs = make_requests(Request, tcfg.vocab, lens, mns)
    sched = ContinuousBatchingScheduler(tcfg, tp, device="cpu", **m)
    sched.serve(reqs)
    st = sched.stats
    sched.close()
    got = [r.out_tokens for r in reqs]
    assert got == [r.out_tokens for r in jreqs]
    assert {k: st[k] for k in SCHED_KEYS} == {k: jst[k] for k in SCHED_KEYS}
    assert {k: st.get(k) for k in ENGINE_KEYS} == \
        {k: jst.get(k) for k in ENGINE_KEYS}
    assert st["phase"] == "co-execution"
    assert st["kernels_substituted"] == jst["kernels_substituted"] >= 1
    # each request alone through the port's lock-step engine: the oracle
    eng = ServingEngine(tcfg, tp, max_len=MAX_LEN, device="cpu")
    oracle = make_requests(Request, tcfg.vocab, lens, mns)
    for r in oracle:
        eng.run_batch([r])
    eng.close()
    assert got == [r.out_tokens for r in oracle]
