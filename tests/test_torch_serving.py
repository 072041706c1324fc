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


# --------------------------------------------------------------------------
# steady iterations write the pool in place (core/graphgen.steady_twin)
# --------------------------------------------------------------------------

def _pool_args(cfg, params, page_size, prefill, seed=3, max_slots=3,
               max_len=32):
    """Random pool leaves, positions and token frame, then one decode
    step's mask and block table or one prefill's two rows (tokens, slots,
    lengths, block-table rows), with the op's attributes."""
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.serve.scheduler import pool_ops
    g = torch.Generator().manual_seed(seed)
    nb = (max_slots * max_len) // page_size + 1 if page_size else 0
    leaves, cdef, axes, paged = pool_ops.build_pool_cache(
        cfg, max_slots, max_len, page_size, nb, device="cpu")
    leaves = [torch.randn(x.shape, generator=g).to(x.dtype) for x in leaves]
    pleaves, pdef = tree_flatten(params)
    mid = pool_ops.register_pool_meta(cfg, pdef, cdef, axes, 0.0, max_len,
                                      page_size, nb, paged)
    attrs = dict(_meta=mid, _n_params=len(pleaves), _n_cache=len(leaves),
                 _has_rng=False)
    pos = torch.randint(1, max_len - 1, (max_slots,), generator=g,
                        dtype=torch.int32)
    tokf = torch.randint(0, cfg.vocab, (max_slots, 1), generator=g,
                         dtype=torch.int32)
    nbps = max_len // page_size if page_size else 0
    table = (1 + torch.randperm(max_slots * nbps, generator=g)
             .reshape(max_slots, nbps).to(torch.int32)) if page_size else None
    if prefill:                 # two rows of 8 tokens into slots 2 and 0
        rest = [pos, tokf, torch.randint(0, cfg.vocab, (2, 8), generator=g,
                                         dtype=torch.int32),
                torch.tensor([2, 0], dtype=torch.int32),
                torch.tensor([8, 8 if cfg.block_pattern[0] == "ssd" else 5],
                             dtype=torch.int32)]
        table = table[[2, 0]] if page_size else None
    else:
        rest = [pos, tokf, torch.tensor([1, 0, 1], dtype=torch.int32)]
    return list(pleaves) + leaves + rest + (
        [table] if page_size else []), attrs


POOL_CASES = {  # case: (model, op, page size, prefill?)
    "decode-dense": ("llama", "serve.slot_decode", 0, False),
    "decode-paged": ("llama", "serve.slot_decode", 8, False),
    "decode-paged-kernel": ("llama", "kernel.slot_decode_paged", 8, False),
    "decode-recurrent": ("mamba", "serve.slot_decode", 0, False),
    "prefill-dense": ("llama", "serve.slot_prefill", 0, True),
    "prefill-paged": ("llama", "serve.slot_prefill", 8, True),
    "prefill-recurrent": ("mamba", "serve.slot_prefill", 0, True),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_op_in_place_form_equals_out_of_place(request, case):
    """A pool op's in-place form gives the out-of-place form's results bit
    for bit, written into (and returned as) its pool inputs, while the
    out-of-place form leaves its inputs as they were."""
    import repro_torch.core.passes.kernel_sub  # noqa: F401  (kernel op)
    from repro_torch.core.ops import OPS
    model, name, page, prefill = POOL_CASES[case]
    _, tcfg, _, tp = request.getfixturevalue(model)
    args, attrs = _pool_args(tcfg, tp, page, prefill)
    lo = attrs["_n_params"]
    hi = lo + attrs["_n_cache"] + 2
    op = OPS[name]
    assert op.writes(**attrs) == tuple((lo + k, 1 + k)
                                       for k in range(hi - lo))
    before = [a.clone() for a in args]
    want = op.impl(*args, **attrs)
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    mine = [a.clone() for a in args]
    got = op.inplace(*mine, **attrs)
    assert len(got) == len(want)
    for k, (g_, w_) in enumerate(zip(got, want)):
        assert torch.equal(g_, w_), f"output {k}"
    for k in range(hi - lo):
        assert got[1 + k] is mine[lo + k]
    for a, b in zip(mine[:lo] + mine[hi:], args[:lo] + args[hi:]):
        assert torch.equal(a, b)        # params and feeds untouched


def _storage_log(sched):
    """Per delivered token: (prefill steps, walker iterations, each pool
    Variable's storage address), read after the queued steps ran."""
    eng, log = sched._tf.engine, []
    pool = sched._cache_vars + [sched._pos_var, sched._tokf_var]

    def stream(req, token, index):
        eng.runner.drain()
        st = sched.stats
        log.append((st["prefill_steps"],
                    st["iterations"] - st["steady_iters"],
                    tuple(eng.store.buffers[v.var_id].untyped_storage()
                          .data_ptr() for v in pool)))
    return stream, log


STEADY_MIXES = {"kernel-sub": ("llama", MIXES["kernel-sub"], KERNELS),
                "churn": ("llama", MIXES["churn"], KERNELS),
                "mamba2": ("mamba", MAMBA_MIXES["prime-mid-decode"], None)}


@pytest.mark.parametrize("mix", sorted(STEADY_MIXES))
def test_steady_iterations_keep_the_pool_in_place(request, mix):
    """Steady decode steps write each pool Variable in place, and so do
    the prefills between them while the steady plan owns the pool: from
    one walker iteration to the next, the buffer keeps its storage.  The
    twin's donation is counted apart (``steady_donated_bytes``);
    ``donated_bytes`` and the greedy tokens stay the reference's."""
    model, mix_kw, opt = STEADY_MIXES[mix]
    jcfg, tcfg, jp, tp = request.getfixturevalue(model)
    m = dict(mix_kw, steady_state=2, steady_probe=1000, optimize=opt)
    lens, mns = m.pop("lens"), [n + 8 for n in m.pop("mns")]
    want, jst = serve(JScheduler(jcfg, jp, **m), JRequest, jcfg.vocab, lens,
                      mns)
    sched = ContinuousBatchingScheduler(tcfg, tp, device="cpu", **m)
    stream, log = _storage_log(sched)
    reqs = make_requests(Request, tcfg.vocab, lens, mns)
    for r in reqs:
        r.stream = stream
    sched.serve(reqs)
    tst = sched.stats
    eng = sched._tf.engine
    twin = eng.family.steady.twin
    sched.close()
    assert [r.out_tokens for r in reqs] == want
    assert {k: tst.get(k) for k in ENGINE_KEYS} == \
        {k: jst.get(k) for k in ENGINE_KEYS}
    assert tst["donated_bytes"] == jst["donated_bytes"]
    assert tst["steady_iters"] > 0 and eng.steady_donated_bytes > 0
    assert twin.inplace and len(twin.don_var_ids) == len(log[0][2])
    runs = {}
    for prefills, walked, ptrs in log:
        runs.setdefault(walked, []).append((prefills, ptrs))
    assert all(len({p for _, p in r}) == 1 for r in runs.values())
    assert max(len(r) for r in runs.values()) >= 8
    # both of kernel-sub's prompts are admitted before the first decode
    assert max(len({n for n, _ in r}) for r in runs.values()) >= (
        1 if mix == "kernel-sub" else 2)


def test_divergence_on_a_probe_after_in_place_steps_rolls_back(llama):
    """A divergence planted on a walker probe after steady steps wrote the
    pool in place: the probe rolls back to the pool as the steady steps
    left it, and the greedy tokens are still the reference's."""
    from repro_torch.serve.scheduler import pool_ops
    jcfg, tcfg, jp, tp = llama
    m = dict(MIXES["churn"], steady_state=2, steady_probe=6)
    lens, mns = m.pop("lens"), [n + 10 for n in m.pop("mns")]
    want, _ = serve(JScheduler(jcfg, jp, optimize=KERNELS, **m), JRequest,
                    jcfg.vocab, lens, mns)
    sched = ContinuousBatchingScheduler(tcfg, tp, optimize=KERNELS,
                                        device="cpu", **m)
    planted = {}

    def stream(req, token, index):
        st = sched.stats
        if not planted and st["steady_iters"] >= 4:
            # the same pool meta under a new id: the next walker iteration
            # (a probe: steady steps do not run the step function) meets
            # a decode node whose attributes differ, and diverges
            meta = pool_ops.pool_meta(sched._attrs["_meta"])
            sched._attrs = dict(sched._attrs,
                                _meta=pool_ops._META.register(meta))
            planted.update(steady=st["steady_iters"], replays=st["replays"],
                           donated=sched._tf.engine.steady_donated_bytes)

    reqs = make_requests(Request, tcfg.vocab, lens, mns)
    for r in reqs:
        r.stream = stream
    sched.serve(reqs)
    tst = sched.stats
    sched.close()
    assert planted and planted["replays"] == 0 and planted["donated"] > 0
    assert tst["replays"] >= 1 and tst["retraces"] >= 1
    assert [r.out_tokens for r in reqs] == want
