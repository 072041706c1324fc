"""The port's pass pipeline against the JAX reference's.

The ``tests/test_passes.py`` programs run through both engines on the
same inputs: fetched values must agree and the pass counters must be
equal.  The one that draws random numbers (``cse_never_merges_feed_slots``)
compares counters only, since the port's draws cannot match
``jax.random``'s.  The kernel substitutions run the wrappers' plain
versions here, on the CPU, as the reference runs its kernels in interpret
mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.passes import resolve_pipeline as j_resolve  # noqa: E402
from repro_torch.core.passes import resolve_pipeline as t_resolve  # noqa: E402

PASS_KEYS = ("nodes_eliminated", "cse_hits", "feeds_folded",
             "segments_coalesced", "kernels_substituted", "fold_divergences",
             "replays", "retraces", "graph_versions", "segments_dispatched",
             "phase")
KERNEL_PIPE = ("fold", "cse", "kernels", "dce", "coalesce")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Pkg:
    def __init__(self, core, **kw):
        self.ops, self.Variable, self._f, self.kw = (
            core.ops, core.Variable, core.function, kw)
        self.GradientTape = core.GradientTape

    def function(self, fn=None, **kw):
        kw = {**self.kw, **kw}
        if fn is None:
            return lambda f: self._f(f, **kw)
        return self._f(fn, **kw)


JAX, PORT = Pkg(jcore), Pkg(tcore, device="cpu")


def _xs(n, shape=(4,), seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(*shape).astype(np.float32) for _ in range(n)]


def _f(x):
    return float(np.asarray(x))


def _flat(outs):
    return np.concatenate([np.ravel(np.asarray(v, dtype=np.float64))
                           for v in outs])


# --------------------------------------------------------------------------
# programs: prog(pkg) -> (fetched values, [TerraFunctions])
# --------------------------------------------------------------------------

def dce_dead_ops(pkg):
    ops = pkg.ops

    def body(x):
        dead = ops.reduce_mean(ops.mul(x, 5.0))     # result discarded
        ops.add(dead, 1.0)                          # dead consumer chain
        return float(ops.reduce_sum(ops.mul(x, 2.0)))

    step = pkg.function(body, optimize="all")
    return [step(x) for x in _xs(6)], [step]


def dce_keeps_writes_and_fetches(pkg):
    ops = pkg.ops
    w = pkg.Variable(np.ones(4, np.float32), "dce_w")

    @pkg.function(optimize="all")
    def step(x):
        w.assign(ops.mul(x, 3.0))
        return float(ops.reduce_max(x))

    outs = []
    for x in _xs(6, seed=1):
        outs.append(step(x))
        step.wait()
        outs.append(np.asarray(step.engine.variable_value(w)))
    return outs, [step]


def cse_var_read_duplicates(pkg):
    ops = pkg.ops
    w = pkg.Variable(np.full(4, 3.0, np.float32), "cse_w")

    def body(x):
        a = ops.mul(w.read(), 2.0)
        b = ops.mul(w.read(), 2.0)          # same expr, different line
        c = ops.add(a, 1.0)
        d = ops.add(b, 1.0)                 # second-level duplicate
        return float(ops.reduce_sum(ops.add(ops.mul(c, x), d)))

    step = pkg.function(body, optimize="all")
    return [step(x) for x in _xs(6, seed=2)], [step]


def cse_hoists_across_switch(pkg):
    ops = pkg.ops
    w = pkg.Variable(np.full(4, 2.0, np.float32), "hoist_w")

    class Cfg:
        flag = False
    cfg = Cfg()

    def body(x):
        base = float(np.asarray(ops.reduce_sum(x)))   # pre-fork anchor
        if cfg.flag:                        # Python control flow -> switch
            y = ops.add(ops.mul(w.read(), 2.0), 1.0)
        else:
            y = ops.sub(ops.mul(w.read(), 2.0), 1.0)
        return float(ops.reduce_sum(ops.add(y, x))) + 0.0 * base

    step = pkg.function(body, optimize="all")
    outs = []
    for i, x in enumerate(_xs(10, seed=4)):
        cfg.flag = i % 2 == 1
        outs.append(step(x))
    return outs, [step]


def feed_folding_diverges(pkg):
    ops = pkg.ops
    m = [np.full(4, 2.0, np.float32)]

    @pkg.function(optimize="all")
    def step(x):
        return float(ops.reduce_sum(ops.add(x, m[0])))

    outs = [step(np.full(4, float(i), np.float32)) for i in range(4)]
    m[0] = np.full(4, 9.0, np.float32)       # folded value changes
    outs.append(step(np.full(4, 1.0, np.float32)))
    outs += [step(np.full(4, float(i), np.float32)) for i in range(3)]
    m[0] = np.full(4, 17.0, np.float32)
    outs.append(step(np.full(4, 1.0, np.float32)))
    return outs, [step]


def feed_folding_off_when_safe(pkg):
    ops = pkg.ops
    m = np.full(4, 2.0, np.float32)

    @pkg.function(optimize="safe")
    def step(x):
        return float(ops.reduce_sum(ops.add(x, m)))

    return [step(np.full(4, float(i), np.float32)) for i in range(4)], [step]


def coalescing_late_reads(pkg):
    ops = pkg.ops

    def body(x):
        a = ops.mul(x, 2.0)
        sa = ops.reduce_sum(a)
        b = ops.mul(a, 3.0)
        sb = ops.reduce_sum(b)
        return float(sa) + float(sb)         # both read late

    opt = pkg.function(body, optimize="all")
    ref = pkg.function(body, optimize="none")
    outs = [(opt(x), ref(x)) for x in _xs(8, seed=5)]
    opt.wait()
    ref.wait()
    return outs, [opt, ref]


def coalescing_keeps_consumed(pkg):
    ops = pkg.ops
    w = pkg.Variable(np.ones(4, np.float32), "co_w")

    @pkg.function(optimize="all")
    def step(x):
        s = float(ops.reduce_sum(ops.mul(x, 2.0)))
        if s > 0:                            # consumed by the continuation
            w.assign(ops.mul(x, 2.0))
        else:
            w.assign(ops.mul(x, -2.0))
        return s

    outs = []
    for i in range(8):
        sign = 1.0 if i % 2 else -1.0
        outs.append(step(np.full(4, sign * (i + 1.0), np.float32)))
        step.wait()
        outs.append(np.asarray(step.engine.variable_value(w)))
    return outs, [step]


def coalescing_mid_iteration_reads(pkg):
    ops = pkg.ops
    w = pkg.Variable(np.full(256, 2.0, np.float32), "don_w")
    seen = []

    @pkg.function(optimize="all")
    def step(x):
        w.assign(ops.mul(w.read(), 2.0))
        s = ops.reduce_sum(w.read())
        w.assign(ops.mul(x, 3.0))
        t = ops.reduce_sum(w.read())
        seen.append(float(s))                # late reads -> coalescible
        return float(t)

    outs = []
    for i in range(6):
        outs.append(step(np.full(256, float(i + 1), np.float32)))
        outs.append(np.asarray(step.engine.variable_value(w)))
    return outs + seen, [step]


def kernel_rmsnorm(pkg):
    ops = pkg.ops
    g = pkg.Variable(np.linspace(0.5, 1.5, 16).astype(np.float32), "krms_g")

    def body(x):
        return float(ops.reduce_sum(ops.rms_norm(x, g.read(), eps=1e-6)))

    opt = pkg.function(body, optimize=KERNEL_PIPE)
    ref = pkg.function(body, optimize="none")
    return [(opt(x), ref(x)) for x in _xs(5, shape=(4, 16), seed=6)], \
        [opt, ref]


def kernel_attention(pkg):
    ops = pkg.ops
    D, S = 16, 8
    mask = np.tril(np.ones((S, S), np.float32))

    def body(q, k, v):
        s = ops.einsum(q, k, expr="bsd,btd->bst")
        s = ops.add(ops.mul(s, 1.0 / D ** 0.5),
                    ops.mul(ops.sub(mask, 1.0), 1e9))
        o = ops.einsum(ops.softmax(s, axis=-1), v, expr="bst,btd->bsd")
        return ops.reduce_sum(o)

    opt = pkg.function(body, optimize=KERNEL_PIPE)
    ref = pkg.function(body, optimize="none")
    r = np.random.RandomState(7)
    outs = []
    for _ in range(5):
        q, k, v = (r.randn(2, S, D).astype(np.float32) for _ in range(3))
        outs.append((_f(opt(q, k, v).numpy()), _f(ref(q, k, v).numpy())))
    return outs, [opt, ref]


def optimize_none_inert(pkg):
    ops = pkg.ops

    def body(x):
        ops.mul(x, 5.0)
        a = ops.mul(x, 2.0)
        b = ops.mul(x, 2.0)
        return float(ops.reduce_sum(ops.add(a, b)))

    step = pkg.function(body, optimize="none")
    outs = [step(x) for x in _xs(5, seed=9)]
    assert step.engine.gp.opt is None
    assert step.engine.gp.otg is step.engine.gp.tg
    return outs, [step]


def passes_rerun_after_retrace(pkg):
    ops = pkg.ops

    class Cfg:
        k = 1.0
    cfg = Cfg()

    @pkg.function(optimize="all")
    def step(x):
        ops.reduce_mean(ops.mul(x, 5.0))
        y = ops.mul(ops.mul(x, 2.0), cfg.k)
        return float(ops.reduce_sum(y))

    xs = _xs(4, seed=10)
    outs = [step(x) for x in xs]
    cfg.k = 2.0                       # divergence -> retrace -> regen
    outs += [step(x) for x in xs]
    return outs, [step]


def kernel_sub_skips_differentiated(pkg):
    """Tape consumers keep the unfused chain alive: substitution must not
    fire when attention intermediates feed .vjp ops."""
    ops = pkg.ops
    D, S = 8, 4
    mask = np.tril(np.ones((S, S), np.float32))
    wv = pkg.Variable(np.eye(D).astype(np.float32), "ks_wv")

    @pkg.function(optimize=KERNEL_PIPE)
    def step(q, k, x):
        with pkg.GradientTape() as tape:
            v = ops.matmul(x, wv.read())
            s = ops.einsum(q, k, expr="bsd,btd->bst")
            s = ops.add(ops.mul(s, 1.0 / D ** 0.5),
                        ops.mul(ops.sub(mask, 1.0), 1e9))
            o = ops.einsum(ops.softmax(s, axis=-1), v, expr="bst,btd->bsd")
            loss = ops.reduce_sum(o)
        (gv,) = tape.gradient(loss, [wv])
        wv.assign_sub(ops.mul(gv, 0.01))
        return float(loss)

    r = np.random.RandomState(8)
    outs = []
    for _ in range(4):
        q, k, x = (r.randn(2, S, D).astype(np.float32) for _ in range(3))
        outs.append(step(q, k, x))
    assert step.phase == "co-execution"
    assert step.stats["kernels_substituted"] == 0
    return outs, [step]


PROGRAMS = [dce_dead_ops, dce_keeps_writes_and_fetches,
            cse_var_read_duplicates, cse_hoists_across_switch,
            feed_folding_diverges, feed_folding_off_when_safe,
            coalescing_late_reads, coalescing_keeps_consumed,
            coalescing_mid_iteration_reads, kernel_rmsnorm,
            kernel_attention, optimize_none_inert,
            passes_rerun_after_retrace, kernel_sub_skips_differentiated]


@pytest.mark.parametrize("prog", PROGRAMS, ids=lambda p: p.__name__)
def test_pass_counters_and_values_match_reference(prog):
    want, jsteps = prog(JAX)
    got, tsteps = prog(PORT)
    try:
        np.testing.assert_allclose(_flat(got), _flat(want), rtol=1e-4,
                                   atol=1e-4)
        for js, ts in zip(jsteps, tsteps):
            assert {k: ts.stats.get(k) for k in PASS_KEYS} == \
                {k: js.stats.get(k) for k in PASS_KEYS}
            assert ts.phase == js.phase
    finally:
        for s in jsteps + tsteps:
            s.close()


def cse_never_merges_feed_slots(pkg):
    """Two ops consuming avals-identical feeds are NOT a common
    subexpression: the fed values are independent (per-iteration RNG keys
    are the canonical case)."""
    ops = pkg.ops

    @pkg.function(optimize="all")
    def step(x):
        a = ops.random_normal((4,))          # distinct key feeds
        b = ops.random_normal((4,))
        return float(ops.reduce_sum(ops.sub(a, b)))

    return [step(x) for x in _xs(8, seed=3)], [step]


def test_cse_never_merges_feed_slots():
    _, (js,) = cse_never_merges_feed_slots(JAX)
    outs, (ts,) = cse_never_merges_feed_slots(PORT)
    try:
        assert ts.phase == "co-execution"
        assert ts.stats["cse_hits"] == 0
        # if the two draws were merged the difference would be exactly zero
        assert any(abs(o) > 1e-6 for o in outs)
        assert {k: ts.stats.get(k) for k in PASS_KEYS} == \
            {k: js.stats.get(k) for k in PASS_KEYS}
    finally:
        js.close()
        ts.close()


def test_kernel_substitutions_fire_on_cpu():
    """Named explicitly, the ``kernels`` pass rewrites rms_norm and the
    softmax-attention chain off the card too (their wrappers then run the
    plain versions)."""
    for prog in (kernel_rmsnorm, kernel_attention):
        _, (opt, ref) = prog(PORT)
        assert opt.stats["kernels_substituted"] == 1
        assert ref.stats["kernels_substituted"] == 0
        opt.close()
        ref.close()


def test_resolve_pipeline_matches_reference_and_adds_kernels_on_cuda():
    for level in ("none", "safe", "all"):
        assert t_resolve(level, "cpu") == j_resolve(level, backend="cpu")
    assert t_resolve(("dce", "cse")) == j_resolve(("dce", "cse"))
    assert "kernels" in t_resolve("all", "cuda")
    assert t_resolve("all", "cuda") == j_resolve("all", backend="tpu")
    with pytest.raises(ValueError):
        t_resolve("everything")
    with pytest.raises(ValueError):
        t_resolve(("dce", "nope"))


def test_kernel_sub_rewrites_every_pattern_on_cuda():
    """Every kernel op has a Hopper kernel, so on the card the pass
    rewrites what it rewrites off the card: the same traced graph gets 1
    substitution for backend "cpu" and 1 for "cuda"."""
    from repro_torch.core.passes import kernel_sub, run_passes
    assert kernel_sub.CUDA_KERNEL_OPS == {"kernel.slot_decode_paged",
                                          "kernel.rms_norm",
                                          "kernel.attention"}
    for prog in (kernel_rmsnorm, kernel_attention):
        _, (opt, ref) = prog(PORT)
        eng, fam = opt.engine, opt.engine.family
        avals = {vid: v.aval for vid, v in eng.vars.items()}
        subs = {backend: run_passes(eng.tg, avals, KERNEL_PIPE, fam.feed_obs,
                                    fam.fetch_obs, backend=backend)
                .counters.get("kernels_substituted", 0)
                for backend in ("cpu", "cuda")}
        assert subs == {"cpu": 1, "cuda": 1}, prog.__name__
        opt.close()
        ref.close()
