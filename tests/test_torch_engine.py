"""The port's co-execution engine against the JAX reference engine.

Each program below is written once against a package namespace and run
through both engines on the same numpy-seeded inputs: the fetched values
must agree and the engine counters must be equal (phase, retraces,
replays, graph versions and the rest of ``ENGINE_KEYS``).  The port runs
with ``device="cpu"``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402

ENGINE_KEYS = ("phase", "retraces", "replays", "graph_versions",
               "traced_iterations", "iterations", "transitions",
               "families", "family_switches", "families_evicted",
               "replayed_entries", "segments_dispatched",
               "segments_recompiled", "segment_cache_hits",
               "walker_fast_hits", "steady_entries", "steady_exits",
               "steady_iters")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Pkg:
    """One package's public surface, with its engine keyword arguments
    (the port is asked for the CPU explicitly)."""

    def __init__(self, core, **kw):
        self.ops, self.Variable = core.ops, core.Variable
        self._function, self._imperative, self.kw = (core.function,
                                                     core.imperative, kw)

    def function(self, fn=None, **kw):
        kw = {**self.kw, **kw}
        if fn is None:
            return lambda f: self._function(f, **kw)
        return self._function(fn, **kw)

    def imperative(self):
        return self._imperative(**self.kw)


JAX, PORT = Pkg(jcore), Pkg(tcore, device="cpu")


def _val(x):
    return np.asarray(x, dtype=np.float64)


# --------------------------------------------------------------------------
# programs: prog(pkg) -> (fetched values, the TerraFunction)
# --------------------------------------------------------------------------

def quickstart(pkg):
    """The README quick start."""
    ops = pkg.ops
    w = pkg.Variable(np.eye(4, dtype=np.float32))

    @pkg.function
    def step(x):
        y = ops.matmul(x, w.read())
        w.assign(ops.add(w.read(), ops.mul(y, 0.01)))
        return float(ops.reduce_sum(y))

    outs = [step(np.full((4, 4), 0.1 * i, np.float32)) for i in range(8)]
    step.wait()
    outs.append(_val(step.engine.variable_value(w)))
    return outs, step


def data_dependent_branch(pkg):
    ops = pkg.ops

    @pkg.function
    def step(x):
        y = ops.mul(x, 2.0)
        if float(ops.reduce_sum(y)) > 10.0:      # gating fetch -> branch
            y = ops.mul(y, 10.0)
        else:
            y = ops.add(y, 1.0)
        return ops.reduce_sum(y)

    xs = [np.full(4, v, np.float32)
          for v in (0.5, 0.5, 3.0, 0.5, 3.0, 4.0, 0.1, 5.0)]
    return [float(step(x)) for x in xs], step


def forced_divergence_replay(pkg):
    """A baked Python constant changes: divergence, rollback, exactly one
    replay of the validated prefix, retrace."""
    ops = pkg.ops

    class Cfg:
        k = 1.0
    cfg = Cfg()

    @pkg.function
    def step(x):
        a = ops.mul(x, 2.0)
        b = ops.add(a, 1.0)
        c = ops.mul(b, cfg.k)              # divergence point when k changes
        return ops.reduce_sum(c)

    outs = []
    for i in range(6):
        if i == 3:
            cfg.k = 2.0
        outs.append(float(step(np.full(4, 1.0 + i, np.float32))))
    return outs, step


def shape_family_flip(pkg):
    """Trace shape A, trace shape B, then flip: dictionary lookups, no
    retrace, no recompile."""
    ops = pkg.ops

    @pkg.function
    def step(x):
        y = ops.mul(x, 2.0)
        s = float(ops.reduce_sum(y))           # gating fetch -> 2 segments
        z = ops.add(y, 1.0)
        return float(ops.reduce_sum(z)) + 0.0 * s

    outs = [step(np.full(4, i + 1.0, np.float32)) for i in range(3)]
    outs += [step(np.full(8, i + 1.0, np.float32)) for i in range(3)]
    for i in range(10):
        outs.append(step(np.full(4 if i % 2 == 0 else 8, 9.0, np.float32)))
    step.wait()
    return outs, step


def object_mutation_fig1c(pkg):
    ops = pkg.ops

    class Cfg:
        scale = 1.0
    cfg = Cfg()

    @pkg.function
    def step(x):
        return ops.reduce_sum(ops.mul(x, cfg.scale))

    outs = []
    for i in range(8):
        if i == 5:
            cfg.scale = 3.0
        outs.append(float(step(np.ones(4, np.float32))))
    return outs, step


def third_party_call(pkg):
    ops = pkg.ops

    @pkg.function
    def step(x):
        y = ops.mul(x, 2.0)
        z = np.sort(y.numpy())[::-1].copy()     # arbitrary third-party code
        return ops.reduce_sum(ops.mul(y, z))

    return [float(step(np.arange(4, dtype=np.float32) + i))
            for i in range(6)], step


def dynamic_loop_rolls(pkg):
    """Varying trip counts roll into a Loop Cond node (a host-side trip
    feed in the port)."""
    ops = pkg.ops

    @pkg.function
    def step(x, n):
        y = x
        for _ in range(n):
            y = ops.add(y, y)
        return ops.reduce_sum(y)

    return [float(step(np.ones(2, np.float32), n))
            for n in (3, 4, 3, 5, 8, 2, 6)], step


def generator_program(pkg):
    ops = pkg.ops

    def gen(x, k):
        for i in range(k):
            yield ops.mul(x, float(i + 1))

    @pkg.function
    def step(x):
        acc = ops.zeros_like(x)
        for t in gen(x, 3):
            acc = ops.add(acc, t)
        return ops.reduce_sum(acc)

    return [float(step(np.full(3, i + 1.0, np.float32)))
            for i in range(5)], step


def try_except_program(pkg):
    ops = pkg.ops

    @pkg.function
    def step(x):
        try:
            y = ops.mul(x, 2.0)
            if float(ops.reduce_sum(y)) > 1e6:
                raise ValueError("overflow")
        except ValueError:
            y = ops.zeros_like(x)
        return ops.reduce_sum(y)

    return [float(step(np.full(2, 1e6 if i == 3 else 1.0, np.float32)))
            for i in range(5)], step


def lazy_mode(pkg):
    ops = pkg.ops
    w = pkg.Variable(np.full(3, 1.5, np.float32))

    @pkg.function(lazy=True)
    def step(x):
        return ops.reduce_sum(ops.mul(w, x))

    return [float(step(np.full(3, i + 1.0, np.float32)))
            for i in range(5)], step


def variable_updates(pkg):
    ops = pkg.ops
    w = pkg.Variable(np.full(3, 2.0, np.float32))

    @pkg.function
    def step(x):
        y = ops.mul(w, x)
        w.assign_add(ops.mul(ops.ones_like(w.read()), 0.5))
        return ops.reduce_sum(y)

    return [float(step(np.full(3, float(i + 1), np.float32)))
            for i in range(10)], step


def segment_cache_after_divergence(pkg):
    ops = pkg.ops

    class Cfg:
        scale = 1.0
    cfg = Cfg()

    @pkg.function
    def step(x):
        y = ops.mul(x, 2.0)
        s = float(ops.reduce_sum(y))       # gating fetch: segment boundary
        z = ops.mul(y, cfg.scale)          # baked const -> diverges on change
        return float(ops.reduce_sum(z)) + 0.0 * s

    outs = []
    for i in range(9):
        if i == 4:
            cfg.scale = 3.0
        outs.append(step(np.full(4, i + 1.0, np.float32)))
    return outs, step


def family_lru_eviction(pkg):
    ops = pkg.ops

    @pkg.function(max_families=2)
    def step(x):
        return float(ops.reduce_sum(ops.mul(x, 2.0)))

    return [step(np.full(n, 1.0, np.float32))
            for n in (4, 4, 8, 8, 16, 16, 4, 4)], step


def steady_state_entry(pkg):
    ops = pkg.ops
    v = pkg.Variable(np.zeros(4, np.float32), "steady_v")

    @pkg.function(optimize="safe", steady_state=3, steady_probe=5)
    def step(x):
        y = ops.mul(x, 2.0)
        v.assign(ops.add(v.read(), y))
        return y

    outs = [_val(step(np.full(4, float(i + 1), np.float32)))
            for i in range(20)]
    outs.append(_val(step.engine.variable_value(v)))
    return outs, step


PROGRAMS = [quickstart, data_dependent_branch, forced_divergence_replay,
            shape_family_flip, object_mutation_fig1c, third_party_call,
            dynamic_loop_rolls, generator_program, try_except_program,
            lazy_mode, variable_updates, segment_cache_after_divergence,
            family_lru_eviction, steady_state_entry]


@pytest.mark.parametrize("prog", PROGRAMS, ids=lambda p: p.__name__)
def test_engine_counters_and_values_match_reference(prog):
    want, jstep = prog(JAX)
    got, tstep = prog(PORT)
    try:
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(_val(g), _val(w), rtol=1e-5,
                                       atol=1e-5, err_msg=f"value {i}")
        js, ts = jstep.stats, tstep.stats
        assert {k: ts.get(k) for k in ENGINE_KEYS} == \
            {k: js.get(k) for k in ENGINE_KEYS}
        assert tstep.phase == jstep.phase
    finally:
        jstep.close()
        tstep.close()


def test_imperative_engine_matches_reference():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = []
    for pkg in (JAX, PORT):
        with pkg.imperative():
            outs.append(pkg.ops.add(pkg.ops.mul(x, 2.0), 1.0).numpy())
    np.testing.assert_allclose(outs[1], outs[0])
    np.testing.assert_allclose(outs[1], x * 2 + 1)


def test_port_engine_keeps_device_state_on_its_device():
    """Variables, staged feeds and outputs of a CPU engine are CPU tensors
    (staging is the design; nothing moves on its own)."""
    ops = PORT.ops
    w = PORT.Variable(np.ones(4, np.float32))

    @PORT.function
    def step(x):
        w.assign(ops.add(w.read(), x))
        return ops.reduce_sum(w.read())

    for i in range(4):
        step(np.full(4, float(i), np.float32))
    step.wait()
    buf = step.engine.variable_value(w)
    assert isinstance(buf, torch.Tensor) and buf.device.type == "cpu"
    assert step.engine.device == torch.device("cpu")
    step.close()
