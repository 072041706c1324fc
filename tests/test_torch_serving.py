"""The slices as a whole: the port's paged continuous-batching scheduler,
co-executed with the ``kernels`` pass, against the JAX scheduler; and the
same scheduler serving the recurrent mamba2 stack (exact-length
admission, the SSD scan in every prefill).

Same params (the reference's, converted), same requests, float32 smoke
llama and mamba2: greedy tokens must be identical and the scheduler and
engine counters equal, ``donated_bytes`` included (the port donates under
the reference's rules, ``core/graphgen._analyze_donation``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JScheduler  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels.ops import ssd_scan as SSD  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.serve.scheduler import \
    ContinuousBatchingScheduler  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
KERNELS = ("cse", "kernels", "dce", "coalesce")
SCHED_KEYS = ("decode_steps", "prefill_steps", "admitted", "retired",
              "generated_tokens", "prefill_tokens", "idle_waits")
ENGINE_KEYS = ("phase", "kernels_substituted", "retraces", "replays",
               "graph_versions", "families", "iterations",
               "traced_iterations", "steady_entries", "steady_iters",
               "segments_dispatched", "segments_recompiled",
               "nodes_eliminated", "cse_hits", "segments_coalesced")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def llama():
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), **F32)
    tcfg = dataclasses.replace(t_smoke("llama3-8b"), **F32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def mamba():
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"), **F32)
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"), **F32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def make_requests(R, vocab, lens, max_news, seed=1):
    rng = np.random.RandomState(seed)
    return [R(prompt=rng.randint(0, vocab, L).astype(np.int32),
              max_new_tokens=mn, arrival_time=0.0)
            for L, mn in zip(lens, max_news)]


def serve(sched, R, vocab, lens, mns):
    reqs = make_requests(R, vocab, lens, mns)
    sched.serve(reqs)
    st = sched.stats
    sched.close()
    return [r.out_tokens for r in reqs], st


# the test_paged.py kernel-substitution settings, and a churn-heavy mix
# (admissions between decodes, early retirements)
MIXES = {
    "kernel-sub": dict(lens=[5, 9], mns=[4, 3], max_slots=2, max_len=32,
                       page_size=8),
    "churn": dict(lens=[5, 8, 13, 8, 5, 16], mns=[4, 9, 3, 5, 7, 4],
                  max_slots=3, max_len=64, page_size=16),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_port_paged_kernel_scheduler_matches_jax(llama, mix):
    jcfg, tcfg, jp, tp = llama
    m = dict(MIXES[mix])
    lens, mns = m.pop("lens"), m.pop("mns")
    want, jst = serve(JScheduler(jcfg, jp, optimize=KERNELS, **m), JRequest,
                      jcfg.vocab, lens, mns)
    before = PA.paged_attention.launches
    got, tst = serve(ContinuousBatchingScheduler(
        tcfg, tp, optimize=KERNELS, device="cpu", **m), Request,
        tcfg.vocab, lens, mns)
    assert got == want                              # greedy tokens identical
    assert {k: tst[k] for k in SCHED_KEYS} == {k: jst[k] for k in SCHED_KEYS}
    assert {k: tst.get(k) for k in ENGINE_KEYS} == \
        {k: jst.get(k) for k in ENGINE_KEYS}
    assert tst["kernels_substituted"] >= 1
    assert tst["phase"] == "co-execution"
    assert tst["donated_bytes"] == jst["donated_bytes"]
    assert PA.paged_attention.launches == before    # CPU: plain version


def test_port_paged_equals_port_dense(llama):
    _, tcfg, _, tp = llama
    m = dict(MIXES["churn"])
    lens, mns = m.pop("lens"), m.pop("mns")
    page = m.pop("page_size")
    dense, _ = serve(ContinuousBatchingScheduler(tcfg, tp, device="cpu",
                                                 **m),
                     Request, tcfg.vocab, lens, mns)
    paged, st = serve(ContinuousBatchingScheduler(
        tcfg, tp, page_size=page, device="cpu", **m), Request, tcfg.vocab,
        lens, mns)
    assert paged == dense
    assert st["retraces"] == 0 and st["replays"] == 0
    assert st["peak_resident_tokens"] > 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_port_use_terra_false_equals_co_execution(llama, paged):
    _, tcfg, _, tp = llama
    m = dict(MIXES["churn"])
    lens, mns = m.pop("lens"), m.pop("mns")
    page = m.pop("page_size")
    page = page if paged else None
    co, st = serve(ContinuousBatchingScheduler(
        tcfg, tp, page_size=page, device="cpu", **m), Request, tcfg.vocab,
        lens, mns)
    plain, pst = serve(ContinuousBatchingScheduler(
        tcfg, tp, page_size=page, use_terra=False, device="cpu", **m),
        Request, tcfg.vocab, lens, mns)
    assert co == plain
    assert st["phase"] == "co-execution"
    assert {k: pst[k] for k in SCHED_KEYS} == {k: st[k] for k in SCHED_KEYS}


def test_scheduler_deferred_features_raise(llama, tmp_path):
    """The scheduler's checkpoints, metrics and sampled profiling do not
    raise: each works on the CPU (tests/test_torch_persist.py and
    tests/test_torch_obs.py hold them against the reference)."""
    _, tcfg, _, tp = llama
    s = ContinuousBatchingScheduler(tcfg, tp, max_slots=2, max_len=32,
                                    device="cpu")
    s.checkpoint(str(tmp_path / "ck"))
    assert s.enable_metrics() is s.metrics
    s.set_profile(1)
    assert s._tf.engine.profile_every == 1
    s.close()
    s = ContinuousBatchingScheduler(tcfg, tp, max_slots=2, max_len=32,
                                    profile=4, device="cpu")
    assert s._tf.engine.profile_every == 4
    s.close()
    s = ContinuousBatchingScheduler.restore(str(tmp_path / "ck"), tcfg, tp,
                                            device="cpu")
    assert s.stats["checkpoint_restores"] == 1
    s.close()


# tests/test_scheduler.py:192-205 (lens [8, 8, 11], two slots), and a mix
# with prime lengths whose later requests are admitted while the earlier
# ones decode
MAMBA_MIXES = {
    "reference": dict(lens=[8, 8, 11], mns=[5, 3, 6], max_slots=2,
                      max_len=64),
    "prime-mid-decode": dict(lens=[13, 8, 37, 5, 11], mns=[6, 2, 5, 7, 3],
                             max_slots=2, max_len=64),
}


@pytest.mark.parametrize("mix", sorted(MAMBA_MIXES))
def test_port_mamba2_scheduler_matches_jax(mamba, mix):
    """Recurrent stacks prefill at exact length; the port's SSD path
    (the plain chunked math on the CPU) serves the same greedy tokens
    with the same counters as the reference."""
    jcfg, tcfg, jp, tp = mamba
    m = dict(MAMBA_MIXES[mix])
    lens, mns = m.pop("lens"), m.pop("mns")
    want, jst = serve(JScheduler(jcfg, jp, **m), JRequest, jcfg.vocab, lens,
                      mns)
    before = SSD.launches
    got, tst = serve(ContinuousBatchingScheduler(tcfg, tp, device="cpu",
                                                 **m),
                     Request, tcfg.vocab, lens, mns)
    assert got == want                              # greedy tokens identical
    assert {k: tst[k] for k in SCHED_KEYS} == {k: jst[k] for k in SCHED_KEYS}
    assert {k: tst.get(k) for k in ENGINE_KEYS} == \
        {k: jst.get(k) for k in ENGINE_KEYS}
    assert tst["phase"] == "co-execution"
    # every admission is its own exact-length prefill step
    assert tst["prefill_tokens"] == sum(lens)
    assert tst["admitted"] == len(lens)
    assert SSD.launches == before                   # CPU: plain version


def test_port_mamba2_use_terra_false_equals_co_execution(mamba):
    _, tcfg, _, tp = mamba
    m = dict(MAMBA_MIXES["prime-mid-decode"])
    lens, mns = m.pop("lens"), m.pop("mns")
    co, st = serve(ContinuousBatchingScheduler(tcfg, tp, device="cpu", **m),
                   Request, tcfg.vocab, lens, mns)
    plain, pst = serve(ContinuousBatchingScheduler(
        tcfg, tp, use_terra=False, device="cpu", **m), Request, tcfg.vocab,
        lens, mns)
    assert co == plain
    assert st["phase"] == "co-execution"
    assert {k: pst[k] for k in SCHED_KEYS} == {k: st[k] for k in SCHED_KEYS}
