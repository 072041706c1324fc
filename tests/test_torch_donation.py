"""Donation, liveness and captured-segment plumbing of the port, against the
JAX reference.

The reference's donation tests (``test_executor.py``, ``test_hotpath.py``,
``test_passes.py``) run through both packages on the same numpy inputs:
fetched values, committed variables and ``donated_bytes`` must be equal.
The port writes a donated variable's new value into the donated buffer,
so the store keeps that buffer (its ``data_ptr``).  Segments free each
value after its last consumer, and the serving sampler draws its noise
from the key on the device.  (What the card captures is held in
``test_torch_capture.py``, which imports no JAX so that it runs there.)
"""

import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import ops as tops_mod  # noqa: E402
from repro_torch.serve.scheduler import pool_ops  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Pkg:
    def __init__(self, core, **kw):
        self.ops, self.Variable, self._function, self.kw = (
            core.ops, core.Variable, core.function, kw)

    def function(self, fn=None, **kw):
        kw = {**self.kw, **kw}
        if fn is None:
            return lambda f: self._function(f, **kw)
        return self._function(fn, **kw)


JAX, PORT = Pkg(jcore), Pkg(tcore, device="cpu")


def _np(x):
    return np.asarray(x, dtype=np.float64)


# --------------------------------------------------------------------------
# programs, each run through both packages
# --------------------------------------------------------------------------

def two_writes(pkg, iters=6, n=1024):
    """test_executor.py:163 — the second write donates the first's buffer."""
    ops, w = pkg.ops, pkg.Variable(np.ones(n, np.float32))

    @pkg.function
    def step(x):
        w.assign(ops.mul(w.read(), 2.0))
        s = float(ops.reduce_sum(w.read()))  # boundary between the writes
        w.assign(ops.mul(x, 3.0))
        return s

    out = []
    for i in range(iters):
        out.append(step(np.full(n, float(i + 1), np.float32)))
        out.append(_np(step.engine.variable_value(w)))
    step.wait()
    return out, step, w


def first_write_only(pkg):
    """test_executor.py:193 — a variable written once is never donatable."""
    ops, w = pkg.ops, pkg.Variable(np.ones(8, np.float32))

    @pkg.function
    def step(x):
        y = ops.mul(w.read(), x)
        w.assign(ops.add(w.read(), 1.0))
        return ops.reduce_sum(y)

    out = [_np(step(np.full(8, 1.0, np.float32))) for _ in range(4)]
    step.wait()
    out.append(_np(step.engine.variable_value(w)))
    return out, step, w


def rollback(pkg):
    """test_executor.py:213 — divergence after donating segments."""
    class Cfg:
        flip = False
    cfg = Cfg()
    ops, w = pkg.ops, pkg.Variable(np.full(256, 2.0, np.float32))

    @pkg.function
    def step(x):
        w.assign(ops.mul(w.read(), 2.0))
        s = float(ops.reduce_sum(w.read()))
        w.assign(ops.mul(x, 3.0))
        if cfg.flip:                      # Python-level change -> divergence
            w.assign(ops.add(w.read(), 1.0))
        return s

    out = [step(np.full(256, float(i + 1), np.float32)) for i in range(4)]
    out.append(step.stats["donated_bytes"])
    cfg.flip = True
    out.append(step(np.full(256, 9.0, np.float32)))
    step.wait()
    out.append(_np(step.engine.variable_value(w)))
    return out, step, w


def mid_iteration_read(pkg):
    """test_hotpath.py:67 — a mid-iteration read of a donatable buffer is a
    private copy that survives the later donation."""
    ops, w = pkg.ops, pkg.Variable(np.ones(64, np.float32), "don_w")
    probe, seen = [False], []

    @pkg.function
    def step(x):
        w.assign(ops.mul(w.read(), 2.0))
        s = float(ops.reduce_sum(w.read()))    # boundary between the writes
        if probe[0]:
            seen.append(_np(step.engine.variable_value(w)).copy())
        w.assign(ops.mul(x, 3.0))              # donates the intermediate
        return s

    out = [step(np.full(64, float(i + 1), np.float32)) for i in range(4)]
    donatable = step.engine.gp.donatable_var_ids == {w.var_id}
    probe[0] = True
    out += [step(np.full(64, float(i + 1), np.float32)) for i in range(4, 7)]
    step.wait()
    return out + seen + [donatable], step, w


def coalesced(pkg):
    """test_passes.py:234 — donation analysed after coalescing."""
    ops, w = pkg.ops, pkg.Variable(np.full(256, 2.0, np.float32), "don_w")
    seen = []

    @pkg.function(optimize="all")
    def step(x):
        w.assign(ops.mul(w.read(), 2.0))
        s = ops.reduce_sum(w.read())
        w.assign(ops.mul(x, 3.0))
        t = ops.reduce_sum(w.read())
        seen.append(float(s))                # late reads -> coalescible
        return float(t)

    out = []
    for i in range(6):
        out.append(step(np.full(256, float(i + 1), np.float32)))
        out.append(_np(step.engine.variable_value(w)))
        out.append(seen[-1])
    step.wait()
    return out, step, w


def view_fetch(pkg):
    """A fetch that is a view of the donated buffer in the donating
    segment (``reshape`` is a view in torch): the donation must not change
    the fetched value."""
    ops, w = pkg.ops, pkg.Variable(np.arange(16, dtype=np.float32))

    @pkg.function
    def step(x):
        w.assign(ops.mul(w.read(), 2.0))
        s = float(ops.reduce_sum(w.read()))
        v = ops.reshape(w.read(), new_shape=(4, 4))    # a view of w
        w.assign(ops.mul(x, 3.0))
        return s, v

    out = []
    for i in range(5):
        s, v = step(np.full(16, float(i + 1), np.float32))
        out += [s, _np(v)]
    step.wait()
    out.append(_np(step.engine.variable_value(w)))
    return out, step, w


def view_between_writes(pkg):
    """A segment between a variable's writer and its donor reads views of
    the variable's buffer (``reshape`` is a view in torch): one is fetched,
    one is carried to a segment after the donation and one becomes another
    variable's value.  The donation must change none of them."""
    ops = pkg.ops
    w = pkg.Variable(np.arange(16, dtype=np.float32))
    u = pkg.Variable(np.zeros((4, 4), np.float32))

    @pkg.function
    def step(x):
        w.assign(ops.mul(w.read(), 2.0))
        s = float(ops.reduce_sum(w.read()))
        v = ops.reshape(w.read(), new_shape=(4, 4))     # a view of w
        c = ops.reshape(w.read(), new_shape=(2, 8))     # carried on
        u.assign(ops.reshape(w.read(), new_shape=(4, 4)))
        t = float(ops.reduce_sum(x))
        w.assign(ops.add(w.read(), x))                  # donates w's buffer
        r = float(ops.reduce_sum(w.read()))
        return s, t, r, v, ops.mul(c, 1.0)

    out = []
    for i in range(5):
        out += [_np(o) for o in step(np.full(16, float(i + 1), np.float32))]
        out.append(_np(step.engine.variable_value(u)))
    step.wait()
    out.append(_np(step.engine.variable_value(w)))
    return out, step, w


PROGRAMS = {"two_writes": two_writes, "first_write_only": first_write_only,
            "rollback": rollback, "mid_iteration_read": mid_iteration_read,
            "coalesced": coalesced, "view_fetch": view_fetch,
            "view_between_writes": view_between_writes}
KEYS = ("phase", "donated_bytes", "replays", "retraces", "iterations",
        "segments_dispatched", "graph_versions")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_donation_matches_reference(name):
    prog = PROGRAMS[name]
    want, jstep, jw = prog(JAX)
    got, tstep, tw = prog(PORT)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6)
    assert {k: tstep.stats.get(k) for k in KEYS} | {"phase": tstep.phase} \
        == {k: jstep.stats.get(k) for k in KEYS} | {"phase": jstep.phase}
    # variable ids count per package: compare which variable is donatable
    def donatable(step, w):
        return {"w" if v == w.var_id else v
                for v in step.engine.gp.donatable_var_ids}
    assert donatable(tstep, tw) == donatable(jstep, jw)
    jstep.close()
    tstep.close()


def test_donated_bytes_fire_like_the_reference():
    _, step, _ = two_writes(PORT)
    assert step.stats["donated_bytes"] > 0
    assert step.stats["donated_bytes"] % 4096 == 0
    _, step0, _ = first_write_only(PORT)
    assert step0.engine.gp.donatable_var_ids == set()
    assert step0.stats["donated_bytes"] == 0
    step.close()
    step0.close()


def test_store_keeps_the_donated_buffer():
    """The second write lands in the first write's buffer: within an
    iteration the store's buffer for ``w`` keeps one data_ptr."""
    ops, w = PORT.ops, PORT.Variable(np.ones(64, np.float32))
    ptrs = []

    @PORT.function
    def step(x):
        w.assign(ops.mul(w.read(), 2.0))
        s = float(ops.reduce_sum(w.read()))
        ptrs.append(step.engine.store.buffers[w.var_id].data_ptr())
        w.assign(ops.mul(x, 3.0))
        return s

    for i in range(6):
        step(np.full(64, float(i + 1), np.float32))
        step.wait()
        ptrs.append(step.engine.store.buffers[w.var_id].data_ptr())
    assert step.phase == "co-execution" and step.stats["donated_bytes"] > 0
    # co-executed iterations: the committed buffer is the donated one
    for mid, end in zip(ptrs[-6::2], ptrs[-5::2]):
        assert mid == end
    np.testing.assert_allclose(_np(step.engine.variable_value(w)),
                               np.full(64, 18.0))
    step.close()


def test_a_buffer_read_between_its_writer_and_its_donor_is_kept():
    """Segments 0 and 2 write ``w``; segment 1 reads ``w``'s buffer as a
    kept input (a view of it could escape), so segment 2 must not donate
    it.  Without that read segment 2 donates.  (A traced program binds such
    a read to the writer's product, so the rule is held here on the
    analysis itself.)"""
    from repro_torch.core.graphgen import GraphProgram, SegProg

    class Prog:
        _final_var_products = staticmethod(
            lambda sp: {v: (sp.index, 0) for v in sp.var_writes})

    def analyse(middle_reads):
        prog = Prog()
        prog.seg_progs = [SegProg(i, [], reads, writes, [], [], [], [])
                          for i, (reads, writes) in enumerate(
                              [([0], [0]), (middle_reads, []), ([0], [0])])]
        GraphProgram._analyze_donation(prog)
        return [(sp.don_var_ids, sp.keep_var_ids, sp.owned_writes)
                for sp in prog.seg_progs]

    assert analyse([]) == [([], [0], [0]), ([], [], []), ([0], [], [])]
    assert analyse([0]) == [([], [0], []), ([], [0], []), ([], [0], [])]


# --------------------------------------------------------------------------
# the steady twin (graphgen.steady_twin): iteration-start buffers donated
# --------------------------------------------------------------------------

def _halve_add(v, x):
    return v * 0.5 + x, x.sum()


def _halve_add_into(v, x):
    return v.mul_(0.5).add_(x), x.sum()


_halve = tops_mod.def_op("test.halve_add", _halve_add,
                         inplace=_halve_add_into,
                         writes=lambda **_: ((0, 0),))


@pytest.mark.parametrize("other_reader", [False, True],
                         ids=["sole-reader", "second-reader"])
def test_steady_twin_writes_in_place_only_for_the_sole_reader(other_reader):
    """A steady plan's twin donates the variable's iteration-start buffer:
    the op's in-place form runs when it is the buffer's only reader, else
    the new value is copied into the buffer after the segment; either way
    the store keeps one buffer and the values are the walker path's."""
    ops, v = PORT.ops, PORT.Variable(np.ones(64, np.float32))

    @PORT.function(steady_state=2, steady_probe=1000)
    def step(x):
        t = ops.reduce_sum(v.read()) if other_reader else None
        new, s = _halve(v.read(), x)
        v.assign(new)
        return s if t is None else ops.add(s, t)

    want, got, ptrs, w = [], [], [], np.ones(64)
    for i in range(10):
        x = np.full(64, 0.25 * (i + 1), np.float32)
        want.append(x.sum() + (w.sum() if other_reader else 0.0))
        w = w * 0.5 + x
        got.append(_np(step(x)))
        step.wait()
        ptrs.append(step.engine.store.buffers[v.var_id].data_ptr())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(_np(step.engine.variable_value(v)), w,
                               rtol=1e-6)
    twin = step.engine.family.steady.twin
    assert twin.don_var_ids == [v.var_id]
    assert bool(twin.inplace) is not other_reader
    assert step.stats["steady_iters"] >= 6
    assert step.stats["donated_bytes"] == 0
    assert step.engine.steady_donated_bytes == 256 * step.stats[
        "steady_iters"]
    assert len(set(ptrs[-6:])) == 1
    # while the plan is live, the store's buffer is the twin's: a read
    # hands out a copy, and a rebind keeps a copy of the caller's tensor
    held = step.engine.variable_value(v)
    mine = torch.full((64,), 2.0)
    step.engine.reset_variable(v, mine)
    step(np.full(64, 1.0, np.float32))
    step.wait()
    np.testing.assert_allclose(_np(held), w, rtol=1e-6)
    assert torch.equal(mine, torch.full((64,), 2.0))
    np.testing.assert_allclose(_np(step.engine.variable_value(v)),
                               np.full(64, 2.0))
    step.close()


# --------------------------------------------------------------------------
# liveness
# --------------------------------------------------------------------------

_LIVE = []


def _counting_step(x):
    out = x * 1.0009765625 + 0.5
    _LIVE.append(weakref.ref(out))
    return out


_counting = tops_mod.def_op("test.counting_step", _counting_step)


def test_segment_frees_values_after_their_last_use():
    """A 64-op chain in one segment: at most a few intermediates are alive
    at any op (the rest were dropped from the segment's env), and the
    result equals the same chain run eagerly."""
    n = 64

    @PORT.function
    def step(x):
        y = x
        for _ in range(n):
            y = _counting(y)
        return ops_sum(y)

    ops_sum = PORT.ops.reduce_sum
    x = np.linspace(0, 1, 32).astype(np.float32)
    want = x.astype(np.float64)
    for _ in range(n):
        want = (want.astype(np.float32) * np.float32(1.0009765625)
                + np.float32(0.5))
    for _ in range(4):
        got = float(step(x))
    assert step.phase == "co-execution"
    peaks = []
    orig = _counting_step

    def probe(x):
        peaks.append(sum(1 for r in _LIVE if r() is not None))
        return orig(x)

    tops_mod.OPS["test.counting_step"].impl = probe
    try:
        _LIVE.clear()
        got = float(step(x))
        step.wait()
    finally:
        tops_mod.OPS["test.counting_step"].impl = orig
    assert len(peaks) == n
    assert max(peaks) <= 2, peaks
    assert got == pytest.approx(float(np.sum(want)), rel=1e-6)
    step.close()


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def test_sample_draws_from_the_key_without_a_host_read():
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(5, 97, generator=g)
    k1 = tops_mod.draw_key(torch.Generator().manual_seed(1))
    k2 = tops_mod.draw_key(torch.Generator().manual_seed(2))
    a = pool_ops._sample(logits, 0.8, k1)
    assert torch.equal(a, pool_ops._sample(logits, 0.8, k1.clone()))
    draws = torch.stack([pool_ops._sample(logits, 0.8, tops_mod.draw_key(
        torch.Generator().manual_seed(s))) for s in range(16)])
    assert len({tuple(d.tolist()) for d in draws}) > 1
    assert a.dtype == torch.int32 and a.shape == (5,)
    assert not torch.equal(a, pool_ops._sample(logits, 0.8, k2)) or \
        len({tuple(d.tolist()) for d in draws}) > 1
    greedy = pool_ops._sample(logits, 0.0, k1)
    assert torch.equal(greedy, torch.argmax(logits, -1).to(torch.int32))
    assert torch.equal(pool_ops._sample(logits, 0.8, None), greedy)
