"""The port's tape autodiff and its training ops against the JAX reference.

``GradientTape`` and the per-op ``<op>.vjp`` ops run through both
packages on the same numpy-seeded inputs: gradients, losses and engine
counters must agree (f32: rtol 1e-4, atol 1e-5).  The random ops cannot
match ``jax.random``'s draws, so the programs that draw compare counters
only, and the port's draws are checked for their distribution and their
determinism.  The port runs with ``device="cpu"``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.trace import to_numpy  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ENGINE_KEYS = ("phase", "retraces", "replays", "graph_versions",
               "traced_iterations", "iterations", "transitions",
               "families", "replayed_entries", "segments_dispatched",
               "walker_fast_hits")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Pkg:
    """One package's public surface; the port is asked for the CPU."""

    def __init__(self, core, **kw):
        self.ops, self.Variable, self.GradientTape = (core.ops, core.Variable,
                                                      core.GradientTape)
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


def _stats(step):
    return {k: (step.phase if k == "phase" else step.stats.get(k))
            for k in ENGINE_KEYS}


# --------------------------------------------------------------------------
# GradientTape (tests/test_coexec.py, ported)
# --------------------------------------------------------------------------

def test_gradient_tape_matches_jax():
    w0 = np.random.RandomState(0).randn(3, 3).astype(np.float32)
    x0 = np.random.RandomState(1).randn(3, 3).astype(np.float32)

    def run(pkg):
        ops = pkg.ops
        with pkg.imperative():
            w = pkg.Variable(w0, "w")
            with pkg.GradientTape() as tape:
                y = ops.matmul(w.read(), x0)
                loss = ops.reduce_sum(ops.square(y))
            g, = tape.gradient(loss, [w])
            return g.numpy()

    want = jax.grad(lambda w: jnp.sum(jnp.square(w @ x0)))(w0)
    np.testing.assert_allclose(run(PORT), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(run(PORT), run(JAX), rtol=RTOL, atol=ATOL)


def training_convergence(pkg):
    ops = pkg.ops
    rng = np.random.RandomState(0)
    W = pkg.Variable(rng.randn(4, 1).astype(np.float32) * 0.1)
    target = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)

    @pkg.function
    def train(x):
        with pkg.GradientTape() as tape:
            pred = ops.matmul(x, W.read())
            loss = ops.reduce_mean(ops.square(ops.sub(pred, ops.matmul(x, target))))
        g, = tape.gradient(loss, [W])
        W.assign_sub(ops.mul(g, 0.1))
        return loss

    losses = [float(train(rng.randn(16, 4).astype(np.float32)))
              for _ in range(30)]
    return losses, train


def test_training_convergence_coexec():
    want, js = training_convergence(JAX)
    got, ts = training_convergence(PORT)
    try:
        assert ts.phase == "co-execution"
        assert got[-1] < got[0] * 0.1
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert _stats(ts) == _stats(js)
    finally:
        js.close()
        ts.close()


def rng_iteration_stable(pkg):
    ops = pkg.ops

    @pkg.function
    def step(x):
        noise = ops.random_normal((4,))
        return ops.reduce_sum(ops.add(x, noise))

    return [float(step(np.zeros(4, np.float32))) for _ in range(6)], step


def test_rng_ops_are_iteration_stable():
    _, js = rng_iteration_stable(JAX)
    outs, ts = rng_iteration_stable(PORT)
    try:
        assert ts.phase == "co-execution"
        # different keys per iteration -> different values
        assert len({round(o, 6) for o in outs}) > 1
        assert _stats(ts) == _stats(js)
    finally:
        js.close()
        ts.close()


def dropout_rate_mutation(pkg):
    """The paper's Figure 1c: a Python object's dropout rate changes
    mid-run; the baked constant diverges and Terra branches the trace."""
    ops = pkg.ops
    w = pkg.Variable(np.random.RandomState(2).randn(8, 8).astype(np.float32)
                     * 0.3, "drop_w")

    class Cfg:
        rate = 0.0
    cfg = Cfg()

    @pkg.function
    def step(x):
        with pkg.GradientTape() as tape:
            h = ops.dropout(ops.relu(ops.matmul(x, w.read())), cfg.rate)
            loss = ops.reduce_mean(ops.square(h))
        g, = tape.gradient(loss, [w])
        w.assign_sub(ops.mul(g, 0.1))
        return float(loss)

    r = np.random.RandomState(3)
    outs = []
    for i in range(10):
        cfg.rate = 0.25 if i >= 4 else 0.0
        outs.append(step(r.randn(4, 8).astype(np.float32)))
    return outs, step


def test_dropout_rate_mutation_branches_like_the_reference():
    want, js = dropout_rate_mutation(JAX)
    got, ts = dropout_rate_mutation(PORT)
    try:
        assert _stats(ts) == _stats(js)
        assert ts.stats["retraces"] >= 1 and ts.phase == "co-execution"
        # rate 0 passes x through: identical until the mutation
        np.testing.assert_allclose(got[:4], want[:4], rtol=RTOL, atol=ATOL)
        assert all(np.isfinite(got))
    finally:
        js.close()
        ts.close()


# --------------------------------------------------------------------------
# every differentiable op's .vjp against the reference's
# --------------------------------------------------------------------------

def _composite(pkg):
    """One terra_op composite, registered under one name in each package."""
    if pkg is jops:
        fn = lambda a, b: jnp.tanh(a @ b) * jnp.sum(a)      # noqa: E731
    else:
        fn = lambda a, b: torch.tanh(a @ b) * torch.sum(a)  # noqa: E731
    pkg.terra_op(fn, name="test.tape.composite")
    return "test.tape.composite"


def _r(seed, *shape, lo=None):
    r = np.random.RandomState(seed)
    if lo is not None:
        return r.uniform(lo, lo + 1.5, shape).astype(np.float32)
    return np.asarray(r.randn(*shape), np.float32)


def _ids(seed, n, shape):
    return np.random.RandomState(seed).randint(0, n, shape).astype(np.int32)


# (id, op name or a function of the ops module giving it, inputs, attrs)
VJP_CASES = [
    ("conv2d_same_s2", "conv2d", [_r(0, 2, 7, 9, 3), _r(1, 3, 3, 3, 4)],
     dict(stride=2, padding="SAME")),
    ("conv2d_same_s1_even_k", "conv2d", [_r(2, 1, 5, 6, 2), _r(3, 2, 2, 2, 3)],
     dict(stride=1, padding="SAME")),
    ("conv2d_valid_s2", "conv2d", [_r(4, 2, 8, 8, 3), _r(5, 3, 3, 3, 2)],
     dict(stride=2, padding="VALID")),
    ("conv2d_explicit_pad", "conv2d", [_r(57, 1, 6, 5, 2), _r(58, 3, 2, 2, 3)],
     dict(stride=2, padding=((1, 0), (0, 2)))),
    ("max_pool2d", "max_pool2d", [_r(6, 2, 6, 6, 3)], dict(window=2, stride=2)),
    ("max_pool2d_overlap", "max_pool2d", [_r(7, 1, 7, 7, 2)],
     dict(window=3, stride=2)),
    ("avg_pool2d", "avg_pool2d", [_r(8, 2, 6, 6, 3)], dict(window=2, stride=2)),
    ("avg_pool2d_overlap", "avg_pool2d", [_r(9, 1, 7, 5, 2)],
     dict(window=3, stride=1)),
    ("resize_nearest", "resize_nearest", [_r(10, 2, 3, 4, 2)], dict(factor=2)),
    ("getitem", "getitem", [_r(11, 4, 5, 3)],
     dict(idx=(slice(None), slice(1, 4), 0))),
    ("softmax_xent_int32", "softmax_xent", [_r(12, 6, 5), _ids(13, 5, (6,))],
     {}),
    ("terra_op_composite", _composite, [_r(14, 3, 4), _r(15, 4, 2)], {}),
    ("matmul", "matmul", [_r(16, 2, 3, 4), _r(17, 4, 5)], {}),
    ("einsum", "einsum", [_r(18, 2, 3, 4), _r(19, 2, 5, 4)],
     dict(expr="bsd,btd->bst")),
    ("softmax", "softmax", [_r(20, 3, 6)], dict(axis=-1)),
    ("log_softmax", "log_softmax", [_r(21, 3, 6)], dict(axis=0)),
    ("layer_norm", "layer_norm", [_r(22, 3, 8), _r(23, 8), _r(24, 8)],
     dict(eps=1e-5)),
    ("rms_norm", "rms_norm", [_r(25, 3, 8), _r(26, 8)], dict(eps=1e-6)),
    ("embedding", "embedding", [_r(27, 10, 4), _ids(28, 10, (2, 3))], {}),
    ("mul_scalar", "mul", [_r(29, 3, 4), 0.5], {}),
    ("div", "div", [_r(30, 3, 4), _r(31, 3, 4, lo=0.5)], {}),
    ("power", "power", [_r(32, 3, 4, lo=0.5), _r(33, 3, 4)], {}),
    ("log", "log", [_r(34, 3, 4, lo=0.5)], {}),
    ("rsqrt", "rsqrt", [_r(35, 3, 4, lo=0.5)], {}),
    ("gelu", "gelu", [_r(36, 3, 4)], {}),
    ("silu", "silu", [_r(37, 3, 4)], {}),
    ("tanh", "tanh", [_r(38, 3, 4)], {}),
    ("sigmoid", "sigmoid", [_r(39, 3, 4)], {}),
    ("maximum", "maximum", [_r(40, 3, 4), _r(41, 3, 4)], {}),
    ("where", "where", [_r(42, 3, 4) > 0, _r(43, 3, 4), _r(44, 3, 4)], {}),
    ("reduce_sum_axis", "reduce_sum", [_r(45, 3, 4, 2)],
     dict(axis=1, keepdims=True)),
    ("reduce_mean", "reduce_mean", [_r(46, 3, 4)], {}),
    ("reduce_max", "reduce_max", [_r(47, 3, 4)], dict(axis=0)),
    ("transpose", "transpose", [_r(48, 2, 3, 4)], dict(axes=(2, 0, 1))),
    ("reshape", "reshape", [_r(49, 2, 6)], dict(new_shape=(3, 4))),
    ("concat", "concat", [_r(50, 2, 3), _r(51, 4, 3)], dict(axis=0)),
    ("stack", "stack", [_r(52, 2, 3), _r(53, 2, 3)], dict(axis=1)),
    ("clip", "clip", [_r(54, 3, 4)], dict(lo=-0.5, hi=0.5)),
    ("abs", "abs", [_r(55, 3, 4)], {}),
    ("one_hot_ids", "one_hot", [_ids(56, 5, (4,))], dict(depth=5)),
]


def _name(mod, spec):
    return spec(mod) if callable(spec) else spec


def _attrs(mod, name, attrs):
    if name == "getitem":
        attrs = dict(attrs, idx=mod._idx_encode(attrs["idx"]))
    return mod._canon_attrs(attrs)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_op_and_vjp_match_reference(case):
    _, spec, inputs, attrs = case
    jname, tname = _name(jops, spec), _name(tops, spec)
    ja = dict(_attrs(jops, jname, attrs))
    ta = dict(_attrs(tops, tname, attrs))
    jin = [jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in inputs]
    tin = [torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x
           for x in inputs]

    jout = _as_tuple(jops.op_impl(jname)(*jin, **ja))
    tout = _as_tuple(tops.op_impl(tname)(*tin, **ta))
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(to_numpy(t), np.asarray(j, np.float32),
                                   rtol=RTOL, atol=ATOL)

    cts = [_r(100 + i, *j.shape) for i, j in enumerate(jout)]
    vj = dict(_n_out=len(cts), _n_in=len(inputs))
    jg = _as_tuple(jops.op_impl(jops.get_vjp_op_name(jname))(
        *[jnp.asarray(c) for c in cts], *jin, **ja, **vj))
    tg = _as_tuple(tops.op_impl(tops.get_vjp_op_name(tname))(
        *[torch.from_numpy(c) for c in cts], *tin, **ta, **vj))
    assert len(tg) == len(jg) == len(inputs)
    for x, t, j in zip(inputs, tg, jg):
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            assert t.dtype == torch.float32
            np.testing.assert_allclose(to_numpy(t), np.asarray(j),
                                       rtol=RTOL, atol=ATOL)
        else:
            # integer/boolean inputs and baked scalars: zeros of the
            # input's own shape (the reference returns float0 there), and
            # the tape's float filter drops them
            assert tuple(t.shape) == np.shape(x)
            assert not torch.any(t != 0)
            assert not tops._is_float(t.dtype) or not isinstance(x, np.ndarray)


def test_vjp_op_keeps_the_reference_name_and_attrs():
    """The tape's backward ops carry the reference's op name and attr set
    (``_n_out``, ``_n_in`` plus the forward's), so TraceGraph nodes and
    the engine counters line up."""
    def names(pkg):
        ops, seen = pkg.ops, []
        with pkg.imperative() as imp:
            w = pkg.Variable(np.ones((3, 2), np.float32), "vjp_w")
            with pkg.GradientTape() as tape:
                h = ops.softmax(ops.matmul(np.ones((4, 3), np.float32),
                                           w.read()), axis=-1)
                loss = ops.softmax_xent(h, np.zeros(4, np.int32))
            tape.gradient(loss, [w])
            for e in imp.engine.trace.entries:
                seen.append((e.op_name, tuple(k for k, _ in e.attrs)))
        return seen

    assert names(PORT) == names(JAX)
    assert ("matmul.vjp", ("_n_in", "_n_out")) in names(PORT)


# --------------------------------------------------------------------------
# the port's random ops: distribution, determinism, dropout's mask
# --------------------------------------------------------------------------

def test_random_draws_are_deterministic_per_key_and_well_spread():
    gen = torch.Generator().manual_seed(0)
    k1, k2 = tops.draw_key(gen), tops.draw_key(gen)
    u = tops.op_impl("random_uniform")(k1, shape=(100_000,))
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 \
        and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert torch.equal(u, tops.op_impl("random_uniform")(k1, shape=(100_000,)))
    assert not torch.equal(u, tops.op_impl("random_uniform")(
        k2, shape=(100_000,)))
    z = tops.op_impl("random_normal")(k1, shape=(400, 250), dtype="float32")
    assert z.shape == (400, 250) and torch.isfinite(z).all()
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    assert tops.op_impl("random_normal")(k1, shape=(8,),
                                         dtype="bfloat16").dtype == \
        torch.bfloat16


def test_dropout_keeps_about_one_minus_rate_and_scales():
    key = tops.draw_key(torch.Generator().manual_seed(1))
    x = torch.ones(200, 500)
    y = tops.op_impl("dropout")(x, key, rate=0.3)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert tops.op_impl("dropout")(x, key, rate=0.0) is x
    # its gradient is the same mask, scaled
    g = tops.op_impl(tops.get_vjp_op_name("dropout"))(
        torch.ones_like(x), x, key, rate=0.3, _n_out=1, _n_in=2)
    torch.testing.assert_close(g[0], y)
    assert g[1].dtype == torch.int64 and not g[1].any()
