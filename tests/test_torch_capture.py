"""Captured segments (core/capture.py): what the engine hands to the CUDA
capture context, and — on the card — captured runs against
``disable_jit()`` runs of the same program.

On the CPU no segment is captured: a recording stand-in for
``CaptureContext`` shows which callables the card would capture (every
segment with its donated buffers as argument 0, every chain, the
``use_terra=False`` scheduler's pool-donating steps) and which it runs
eagerly (a segment holding an op registered as not capturable).  The
tests marked ``cuda`` need the card; this file imports no JAX so that they
run there:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_capture.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import capture as capture_mod  # noqa: E402
from repro_torch.core import ops as tops_mod  # noqa: E402
from repro_torch.serve.scheduler import pool_ops  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float64)


def cpu_function(fn=None, **kw):
    if fn is None:
        return lambda f: tcore.function(f, device="cpu", **kw)
    return tcore.function(fn, device="cpu", **kw)


# --------------------------------------------------------------------------
# what the card captures: a recording stand-in for CaptureContext
# --------------------------------------------------------------------------

class Recording:
    """Records what the engine asks to capture; runs everything eagerly."""

    def __init__(self):
        self.wrapped, self.eager_fns = [], 0

    def wrap(self, fn, donate=(), host=None, home=False):
        self.wrapped.append((fn, tuple(donate), host))

        def call(*args):
            if host is not None:
                host(*args)
            return fn(*args)
        call.captured = True
        return call

    def eager(self, fn):
        self.eager_fns += 1
        return fn

    def release(self):
        self.released = True


_host_sum = tops_mod.def_op(
    "test.host_sum", lambda x: torch.full_like(x, float(x.sum().item())),
    capturable=False)


def test_segments_and_chains_are_handed_to_the_capture_context():
    """With a capture context, every segment is wrapped with its donated
    buffers as argument 0 and its Case Select slots as its host key; a
    chain is wrapped too; a segment holding an op registered as not
    capturable is compiled eager, explicitly."""
    ops = tcore.ops
    w = tcore.Variable(np.ones(8, np.float32))
    flip = [0]

    @cpu_function
    def step(x):
        w.assign(ops.mul(w.read(), 2.0))
        s = float(ops.reduce_sum(w.read()))
        if flip[0]:
            y = ops.add(x, 1.0)
            t = float(ops.reduce_sum(y))      # mid-branch fetch -> chain
        else:
            t = 0.0
        w.assign(ops.mul(x, 3.0))
        return s + t

    rec = Recording()
    step.engine.capture = rec
    for i in range(6):
        flip[0] = i % 2
        step(np.full(8, float(i + 1), np.float32))
    step.wait()
    assert step.phase == "co-execution"
    gp = step.engine.gp
    assert all(getattr(sp.fn, "captured", False) for sp in gp.seg_progs)
    donates = {d for _, d, h in rec.wrapped if h is not None}
    assert donates == {(0,)}
    assert any(h is None for _, _, h in rec.wrapped)       # the chain
    assert rec.eager_fns == 0
    np.testing.assert_allclose(_np(step.engine.variable_value(w)),
                               np.full(8, 18.0))
    step.close()
    assert rec.released

    @cpu_function
    def host(x):
        return float(ops.reduce_sum(_host_sum(ops.mul(x, 2.0))))

    rec2 = Recording()
    host.engine.capture = rec2
    for _ in range(4):
        assert host(np.ones(4, np.float32)) == 32.0
    assert host.phase == "co-execution"
    assert rec2.eager_fns == len(host.engine.gp.seg_progs) >= 1
    assert not any(getattr(sp.fn, "captured", False)
                   for sp in host.engine.gp.seg_progs)
    host.close()


def test_disable_jit_compiles_eager():
    rec = Recording()
    ops = tcore.ops

    @cpu_function
    def step(x):
        return float(ops.reduce_sum(ops.mul(x, 2.0)))

    step.engine.capture = rec
    with capture_mod.disable_jit():
        assert capture_mod.jit_disabled()
        for _ in range(4):
            step(np.ones(4, np.float32))
    assert not capture_mod.jit_disabled()
    assert step.phase == "co-execution" and rec.wrapped == []
    step.close()


def test_baseline_steps_donate_the_pool():
    """``use_terra=False`` steps write the pool in place and hand the
    pool tensors back."""
    calls = []

    def fake(*args, **attrs):
        calls.append(attrs)
        return (args[0] + 1,) + tuple(a * 2 for a in args[1:4])

    tops_mod.OPS["serve.slot_decode"], saved = (
        tops_mod.OpDef("serve.slot_decode", fake),
        tops_mod.OPS["serve.slot_decode"])
    try:
        dec, pre, ctx = pool_ops.baseline_steps(1, 1, {"_meta": 7},
                                                torch.device("cpu"))
        assert ctx is None
        pool = [torch.ones(3), torch.ones(2), torch.ones(1)]
        outs = dec(torch.zeros(1), *pool, torch.zeros(1))
    finally:
        tops_mod.OPS["serve.slot_decode"] = saved
    assert calls == [{"_meta": 7}]
    assert all(o is p for o, p in zip(outs[1:], pool))
    assert all(torch.equal(p, torch.full_like(p, 2.0)) for p in pool)


def test_a_capture_records_only_its_own_threads_launches():
    """A graph's launches are what its capturing thread counted: a wrapper
    called on another thread meanwhile still counts, and is not recorded
    into the graph."""
    import threading

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.build import count_launch, recording_launches

    n0 = kops.rmsnorm.launches
    other = threading.Thread(target=count_launch, args=(kops.rmsnorm,))
    with recording_launches() as rec:
        count_launch(kops.rmsnorm)
        count_launch(kops.ssd_scan)
        other.start()
        other.join()
        with recording_launches() as inner:
            count_launch(kops.rmsnorm)
        count_launch(kops.rmsnorm)
    count_launch(kops.rmsnorm)
    assert rec == {kops.rmsnorm: 2, kops.ssd_scan: 1}
    assert inner == {kops.rmsnorm: 1}
    assert kops.rmsnorm.launches - n0 == 5
    kops.ssd_scan.launches -= 1


def test_pytree_keeps_no_leaf_alive():
    """A replay flattens its arguments and unflattens its outputs: the
    leaves (a step's variable buffers) must die with their last
    reference, not wait for the cyclic collector (a recursive closure
    in the helpers held every step's buffers until a collection)."""
    import gc
    import weakref
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    gc.disable()
    try:
        t = torch.zeros(8)
        ref = weakref.ref(t)
        leaves, treedef = tree_flatten(((t,), {"a": [t, None]}))
        out = tree_unflatten(treedef, leaves)
        assert out[0][0] is t and out[1]["a"] == [t, None]
        del t, leaves, out
        assert ref() is None
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# on the card: captured against disable_jit()
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the capture "
                    "phase (captured against disable_jit) on the card")
    return torch.device("cuda")


def card_program(dev, iters=10, flip_at=7):
    """A branch, a loop with a trip feed, a mid-call fetch, a chain and a
    divergence after captured iterations."""
    ops = tcore.ops
    w = tcore.Variable(np.ones(256, np.float32))
    cfg = {"flip": False}

    @tcore.function(device=dev)
    def step(x, trips):
        w.assign(ops.mul(w.read(), 1.5))
        s = float(ops.reduce_sum(w.read()))          # mid-call fetch
        y = x
        for _ in range(int(trips)):                  # loop, trip feed
            y = ops.tanh(ops.add(y, 0.25))
        if s > 0:                                    # branch
            z = ops.mul(y, 2.0)
            t = float(ops.reduce_max(z))             # mid-branch: chain
        else:
            z, t = y, 0.0
        w.assign(ops.add(ops.mul(x, 3.0), z))        # donated
        if cfg["flip"]:                              # divergence
            w.assign(ops.mul(w.read(), 0.5))
        return s + t

    out = []
    for i in range(iters):
        cfg["flip"] = i == flip_at
        x = np.linspace(-1, 1, 256).astype(np.float32) * (i + 1) / iters
        out.append(step(x, np.int32(2 + i % 2)))
    step.wait()
    out.append(np.asarray(step.engine.variable_value(w).cpu()))
    return out, step


@pytest.mark.cuda
def test_cuda_captured_program_equals_disable_jit(card):
    with capture_mod.disable_jit():
        want, eager = card_program(card)
    got, cap = card_program(card)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w_), rtol=1e-6, atol=1e-6)
    keys = ("replays", "retraces", "iterations", "donated_bytes",
            "segments_dispatched")
    assert {k: cap.stats[k] for k in keys} == \
        {k: eager.stats[k] for k in keys}
    st = cap.engine.capture.stats
    assert st["graphs"] > 0 and st["replays"] > 0 and st["eager_fns"] == 0
    assert eager.engine.capture.stats["graphs"] == 0
    cap.close()
    eager.close()


def _home_step(don, x):
    """A segment's form: its donated buffer written in place and handed
    back, and a fetch."""
    (a,) = don
    a.mul_(0.5).add_(x)
    return (a,), a.sum()


def steady_program(dev, iters=24):
    """A steady plan (its twin donates ``w``), walker probes between."""
    ops = tcore.ops
    w = tcore.Variable(np.ones(4096, np.float32))

    @tcore.function(device=dev, steady_state=2, steady_probe=5)
    def step(x):
        y = ops.mul(x, 2.0)
        w.assign(ops.add(ops.mul(w.read(), 0.5), y))
        return y

    out = [_np(step(np.full(4096, 0.01 * (i + 1), np.float32)))
           for i in range(iters)]
    step.wait()
    out.append(_np(step.engine.variable_value(w)))
    return out, step


@pytest.mark.cuda
def test_cuda_home_buffers_copy_only_a_moved_tensor(card):
    """A graph wrapped with ``home=True`` copies nothing while the caller
    hands its home buffer back, copies once (counted in ``copy_in_bytes``
    and ``home_copies``) when the caller passes a moved tensor, never
    recaptures, and computes what the eager function does; a steady
    program, whose twin is wrapped so, equals its ``disable_jit()`` run."""
    ctx = capture_mod.CaptureContext(card)
    f = ctx.wrap(_home_step, donate=(0,), home=True)
    x = torch.linspace(-1, 1, 4096, device=card)
    a = torch.ones(4096, device=card)
    want = torch.ones(4096, device=card)
    st = ctx.stats
    for i in range(8):
        if i == 5:
            a = a.clone()                       # the variable moved
        before = dict(st)
        (a,), s = f((a,), x)
        want = want * 0.5 + x
        torch.testing.assert_close(a, want, rtol=0, atol=0)
        torch.testing.assert_close(s, want.sum(), rtol=0, atol=0)
        if i >= 2:                              # replays
            moved = 4096 * 4 if i == 5 else 0
            assert st["copy_in_bytes"] - before["copy_in_bytes"] == moved
            assert st["home_copies"] - before["home_copies"] == (i == 5)
    assert st["graphs"] == 1 and st["recaptures"] == 0
    assert st["replays"] == 7 and st["home_copies"] == 1
    ctx.release()

    with capture_mod.disable_jit():
        want, eager = steady_program(card)
    got, cap = steady_program(card)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-6, atol=1e-6)
    cs = cap.engine.capture.stats
    assert cap.stats["steady_iters"] > 0
    assert cap.engine.steady_donated_bytes > 0
    assert cs["recaptures"] == 0 and cs["home_copies"] >= 1
    assert cap.stats["steady_iters"] == eager.stats["steady_iters"]
    cap.close()
    eager.close()


@pytest.mark.cuda
def test_cuda_replays_advance_the_launch_counters(card):
    from repro_torch.kernels import ops as kops
    ops = tcore.ops
    g = tcore.Variable(np.linspace(0.5, 1.5, 64).astype(np.float32))

    @tcore.function(device=card, optimize="all")
    def step(x):
        return float(ops.reduce_sum(ops.rms_norm(x, g.read(), eps=1e-6)))

    # a new x every call: a constant feed would be folded (optimize="all")
    xs = [np.random.RandomState(i).randn(8, 64).astype(np.float32)
          for i in range(8)]
    for x in xs[:3]:                # trace, warm-up, capture
        step(x)
    n0 = kops.rmsnorm.launches
    for x in xs[3:]:
        step(x)
    step.wait()
    assert step.engine.capture.stats["replays"] >= 5
    assert kops.rmsnorm.launches - n0 == 5
    step.close()


_sync_sum = tops_mod.def_op(            # reads the device on the host, but
    "test.sync_sum",                    # is (wrongly) left capturable
    lambda x: x * float(x.sum().item()))


@pytest.mark.cuda
def test_cuda_non_capturable_op_runs_eager_and_capture_errors_raise(card):
    """A segment holding an op registered as not capturable runs eagerly
    (counted in ``eager_fns``) with the right values; a host read inside
    a capturable segment makes its capture raise, with no eager fallback
    (this test runs last: a failed capture leaves its pool behind)."""
    ops = tcore.ops
    x = np.arange(4, dtype=np.float32)

    @tcore.function(device=card)
    def host(x):
        return float(ops.reduce_sum(_host_sum(ops.mul(x, 2.0))))

    for _ in range(4):
        assert host(x) == 48.0
    st = host.engine.capture.stats
    assert host.phase == "co-execution"
    assert st["eager_fns"] >= 1 and st["graphs"] == 0
    host.close()

    @tcore.function(device=card)
    def bad(x):
        return float(ops.reduce_sum(_sync_sum(ops.mul(x, 2.0))))

    with pytest.raises(Exception):
        for _ in range(4):          # trace, warm-up, then the capture
            bad(x)
    assert bad.engine.capture.stats["graphs"] == 0
    bad.close()


def test_a_capture_records_launches_into_its_stream_from_other_threads(
        monkeypatch):
    """A thread with no record of its own whose current stream is being
    captured — autograd's device thread running the backward of a
    captured train step (the SSD scan's remat recompute) — counts into
    the open capture's record; a thread not capturing does not."""
    import threading

    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.build import count_launch, recording_launches

    capturing = threading.local()
    monkeypatch.setattr(build, "_stream_capturing",
                        lambda: getattr(capturing, "on", False))

    def backward_thread():
        capturing.on = True
        count_launch(kops.ssd_scan)

    n0 = kops.ssd_scan.launches
    with recording_launches() as rec:
        for target in (backward_thread,
                       lambda: count_launch(kops.ssd_scan)):
            t = threading.Thread(target=target)
            t.start()
            t.join()
    assert rec == {kops.ssd_scan: 1}
    assert kops.ssd_scan.launches - n0 == 2
    kops.ssd_scan.launches -= 2
