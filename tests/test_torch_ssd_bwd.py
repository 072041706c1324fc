"""The SSD scan's gradient: ``kernels.ref.ref_ssd_bwd`` (the backward
kernel's own decomposition in plain torch: the forward's chunk and state
passes recomputed, then the gradient's chunk pass, reverse state pass and
gradient pass) against ``jax.grad`` of the reference's
``repro.models.ssm.ssd_chunked`` and against autograd of the port's
``ssd_chunked_plain``, for all five inputs, f32, within 1e-4 of each
gradient's largest value.  ``kernels.ops.ssd_scan_bwd`` on CPU tensors
runs ``ref_ssd_bwd``; its refusals, its scratch plan and ``SSDScan``'s
backward are held here too.  ``ref_ssd_bwd(..., round_bf16=True)``, the
bf16 kernels' rounding points (operands computed in f32 entering as bf16
hi + lo), is held to ``jax.grad`` within 5e-5.  The CUDA kernel runs only
on the card: the ``cuda``-marked tests below hold it against both plain
versions there (relative to the largest value: f32 1e-4; bf16 1.5e-2
against ``ref_ssd_bwd`` and 5e-2 against plain autograd, and 5e-3 against
the emulation, where only the bf16 outputs' rounding and the order of
f32 sums differ; two calls equal to the bit) and skip elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_bwd.py
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ref import SSD_SWEEP, ref_ssd_bwd  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL_GRAD = 1e-4                       # of each gradient's largest value
TOL_CARD = {"float32": 1e-4, "bfloat16": 5e-2}
TOL_CARD_REF = {"float32": 1e-4, "bfloat16": 1.5e-2}
# the bf16 emulation against jax.grad: hi + lo keeps ~16 significant bits
# of each operand computed in f32 (2^-16 = 1.5e-5 of it)
TOL_EMU = 5e-5
# the bf16 kernel against the emulation: half a bf16 step of the largest
# value (2^-8) from the outputs' rounding, plus the order of f32 sums
TOL_CARD_EMU = 5e-3
NAMES = ("dx", "ddt", "dA", "dB", "dC")
# (B, S, H, P, N, chunk of the reference): S a multiple of the chunk, a
# ragged S, S below the chunk (one chunk), S = 1, other H/P/N, and the
# kernel's chunk of 64 crossed three times with a ragged tail
CASES = [
    (1, 64, 2, 16, 16, 16),
    (2, 128, 4, 32, 32, 32),
    (1, 130, 3, 32, 24, 64),
    (2, 20, 2, 16, 16, 64),
    (1, 1, 2, 16, 16, 16),
    (1, 37, 2, 16, 16, 16),
    (1, 200, 2, 64, 128, 64),
    (2, 96, 3, 16, 8, 32),
]
# the launcher's widths (P 64, N 128) over a few chunks of 64
LAUNCH_LIKE = (1, 256, 4, 64, 128, 64)
# N the bf16 kernel zero-pads to a multiple of 16 (8, 20, 4), and P in one
# ragged block of 48 and in blocks of 64 + 16
PADDED = [(2, 96, 3, 16, 8, 32), (1, 100, 2, 48, 20, 64),
          (1, 70, 2, 80, 4, 64)]


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the reference comparisons run with JAX on the CPU")
    import jax.numpy as jnp
    return jax, jnp


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(case, seed=5):
    """x, dt, A, Bm, Cm (the reference test's distributions) and the
    cotangents dy, dh as float32 numpy arrays."""
    B, S, H, P, N, _ = case
    r = np.random.RandomState(seed)
    x = r.randn(B, S, H, P).astype(np.float32)
    dt = (np.log1p(np.exp(r.randn(B, S, H))) * 0.1).astype(np.float32)
    A = (-np.exp(r.randn(H) * 0.3)).astype(np.float32)
    Bm = r.randn(B, S, N).astype(np.float32)
    Cm = r.randn(B, S, N).astype(np.float32)
    dy = r.randn(B, S, H, P).astype(np.float32)
    dh = r.randn(B, H, P, N).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy, dh


def _t(a, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _within(got, want, tol, what):
    for name, g, w in zip(NAMES, got, want):
        g, w = (np.asarray(a.float().cpu() if isinstance(a, torch.Tensor)
                           else a, np.float32) for a in (g, w))
        assert g.shape == w.shape, (what, name)
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= tol * scale, f"{what} {name}: {err} > {tol} x {scale}"


def _plain_grads(args, dy, dh, chunk):
    """Autograd of ssd_chunked_plain for the cotangents dy (and dh)."""
    xs = [a.detach().clone().requires_grad_(True) for a in args]
    out = TS.ssd_chunked_plain(*xs, chunk, return_final=dh is not None)
    if dh is None:
        loss = (out.float() * dy.float()).sum()
    else:
        loss = (out[0].float() * dy.float()).sum() + (out[1] * dh).sum()
    return torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("kchunk", [64, 16])
@pytest.mark.parametrize("final", [False, True], ids=["y", "y+h_final"])
@pytest.mark.parametrize("case", CASES)
def test_ref_ssd_bwd_matches_jax_grad(case, final, kchunk, jax_ref):
    """ref_ssd_bwd at the kernel's chunk (64) and at 16 (more chunks at
    these lengths) against jax.grad of the reference's ssd_chunked at its
    own chunk, every input."""
    jax, jnp = jax_ref
    from repro.models import ssm as JS
    args, dy, dh = _inputs(case)

    def j_loss(*xs):
        out = JS.ssd_chunked(*xs, case[-1], return_final=final)
        if final:
            return jnp.sum(out[0] * dy) + jnp.sum(out[1] * dh)
        return jnp.sum(out * dy)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))
    got = ref_ssd_bwd(*(_t(a) for a in args), _t(dy),
                      _t(dh) if final else None, chunk=kchunk)
    assert [g.dtype for g in got] == [torch.float32] * 5
    _within(got, want, TOL_GRAD, f"{case} final={final} chunk={kchunk}")


def _bf16_exact(a):
    """a rounded to bf16 and back: the values the bf16 kernel reads."""
    return np.asarray(torch.from_numpy(a).bfloat16().float())


@pytest.mark.parametrize("final", [False, True], ids=["y", "y+h_final"])
@pytest.mark.parametrize("case", SSD_SWEEP + [LAUNCH_LIKE])
def test_ref_ssd_bwd_bf16_emulation_matches_jax_grad(case, final, jax_ref):
    """ref_ssd_bwd with the bf16 kernels' rounding points (round_bf16) at
    the kernel's chunk against jax.grad of the reference's ssd_chunked, on
    inputs exact in bf16 (x, B, C and dy as the kernel reads them), every
    input, within TOL_EMU of each gradient's largest value; no NaN."""
    jax, jnp = jax_ref
    from repro.models import ssm as JS
    args, dy, dh = _inputs(case, seed=13)
    args = [a if i in (1, 2) else _bf16_exact(a) for i, a in enumerate(args)]
    dy = _bf16_exact(dy)

    def j_loss(*xs):
        out = JS.ssd_chunked(*xs, case[-1], return_final=final)
        if final:
            return jnp.sum(out[0] * dy) + jnp.sum(out[1] * dh)
        return jnp.sum(out * dy)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))
    got = ref_ssd_bwd(*(_t(a) for a in args), _t(dy),
                      _t(dh) if final else None, round_bf16=True)
    assert not any(bool(torch.isnan(g).any()) for g in got)
    _within(got, want, TOL_EMU, f"{case} final={final} round_bf16")


def test_ref_ssd_bwd_round_bf16_rounds():
    """At the launcher's widths the emulation differs from the f32 passes
    (it rounds), by no more than the split's ~2^-16 allows."""
    args, dy, dh = _inputs(LAUNCH_LIKE, seed=14)
    t = [_t(a) for a in args]
    exact = ref_ssd_bwd(*t, _t(dy), _t(dh))
    emu = ref_ssd_bwd(*t, _t(dy), _t(dh), round_bf16=True)
    assert any(not torch.equal(a, b) for a, b in zip(exact, emu))
    _within(emu, exact, TOL_EMU, "round_bf16 vs f32")


@pytest.mark.parametrize("final", [False, True], ids=["y", "y+h_final"])
@pytest.mark.parametrize("case", [SSD_SWEEP[i] for i in (0, 4, 9, 11)])
def test_ref_ssd_bwd_matches_plain_autograd(case, final):
    """ref_ssd_bwd against autograd of ssd_chunked_plain (the path the
    kernel takes off the card), f32, on SSD_SWEEP's cases."""
    args, dy, dh = _inputs(case, seed=7)
    t = [_t(a) for a in args]
    want = _plain_grads(t, _t(dy), _t(dh) if final else None, case[-1])
    got = ref_ssd_bwd(*t, _t(dy), _t(dh) if final else None)
    _within(got, want, TOL_GRAD, f"{case} final={final}")


def test_ref_ssd_bwd_returns_input_dtypes():
    """bf16 x/B/C/dy and bf16 dt (the model path's types): gradients in
    the inputs' dtypes, dA in f32, close to the f32 computation."""
    args, dy, dh = _inputs((2, 70, 2, 16, 16, 64), seed=8)
    bf = torch.bfloat16
    t = [_t(args[0], bf), _t(args[1], bf), _t(args[2]), _t(args[3], bf),
         _t(args[4], bf)]
    got = ref_ssd_bwd(*t, _t(dy, bf), _t(dh))
    assert [g.dtype for g in got] == [bf, bf, torch.float32, bf, bf]
    want = ref_ssd_bwd(*(a.float() for a in t), _t(dy, bf).float(), _t(dh))
    _within(got, want, TOL_CARD["bfloat16"], "bf16")


def test_ssd_scan_bwd_runs_the_plain_version_on_cpu():
    """kops.ssd_scan_bwd on CPU tensors is ref_ssd_bwd at the kernel's
    chunk, and launches nothing."""
    SS = sys.modules["repro_torch.kernels.ssd_scan"]
    args, dy, dh = _inputs(SSD_SWEEP[9])
    t = [_t(a) for a in args]
    before = kops.ssd_scan_bwd.launches
    got = kops.ssd_scan_bwd(*t, _t(dy), _t(dh))
    want = ref_ssd_bwd(*t, _t(dy), _t(dh), chunk=SS.CHUNK)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kops.ssd_scan_bwd.launches == before


def test_ssd_scan_bwd_rejects_what_the_kernel_does_not_take():
    args, dy, dh = _inputs(SSD_SWEEP[0])
    x, dt, A, Bm, Cm = (_t(a) for a in args)
    dy, dh = _t(dy), _t(dh)
    with pytest.raises(ValueError):
        kops.ssd_scan_bwd(x[0], dt, A, Bm, Cm, dy[0])         # not 4-d
    with pytest.raises(ValueError):
        kops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy[:, :5])        # dy shape
    with pytest.raises(ValueError):
        kops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dh[..., :8])  # dh shape
    with pytest.raises(ValueError):
        kops.ssd_scan_bwd(x, dt[:, :5], A, Bm, Cm, dy)        # dt shape
    with pytest.raises(ValueError):                          # two devices
        kops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy.to("meta"))
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm, dy)]
    with pytest.raises(NotImplementedError):
        kops.ssd_scan_bwd(*meta)


def test_ssd_scan_bwd_scratch_plan():
    """The backward's scratch at the launcher's shape (x [8, 2048, 24,
    64], N 128: 32 chunks, 2 groups of 12 heads): recomputed states, g/D,
    and the per-CTA dB/dC partials; one chunk needs no recomputed
    states."""
    SS = sys.modules["repro_torch.kernels.ssd_scan"]
    parts = dict(SS.bwd_scratch(8, 2048, 24, 64, 128))
    pn = 4 * 8 * 32 * 24 * 64 * 128
    assert SS.plan(8, 2048, 24) == (32, 12)
    assert parts == {"states": pn, "decay": 4 * 8 * 32 * 24, "gs": pn,
                     "gdecay": 4 * 8 * 32 * 24,
                     "dBp": 4 * 8 * 32 * 2 * 64 * 128,
                     "dCp": 4 * 8 * 32 * 2 * 64 * 128,
                     "dAp": 4 * 8 * 32 * 24}
    assert SS.bwd_scratch_bytes(8, 2048, 24, 64, 128) % 256 == 0
    one = dict(SS.bwd_scratch(1, 64, 24, 64, 128))
    assert one["states"] == one["decay"] == 0 and one["gs"] > 0


@pytest.mark.parametrize("final", [False, True], ids=["y", "y+h_final"])
def test_ssd_scan_function_backward_on_cpu(final):
    """SSDScan's backward goes through kops.ssd_scan_bwd (ref_ssd_bwd on
    the CPU): the gradients of the inputs that need one, None for the
    rest, and only the h_final cotangent when y's is absent."""
    case = SSD_SWEEP[9]
    args, dy, dh = _inputs(case, seed=9)
    t = [_t(a) for a in args]
    xs = [a.clone().requires_grad_(i != 2) for i, a in enumerate(t)]
    out = TS.SSDScan.apply(*xs, case[-1], final)
    if final:
        y, h = out
        loss = (h * _t(dh)).sum()               # y's cotangent absent
        want = ref_ssd_bwd(*t, torch.zeros_like(t[0]), _t(dh))
    else:
        y = out
        loss = (y * _t(dy)).sum()
        want = ref_ssd_bwd(*t, _t(dy))
    got = torch.autograd.grad(loss, [a for a in xs if a.requires_grad])
    _within(got, [w for i, w in enumerate(want) if i != 2], 1e-6,
            f"final={final}")
    assert xs[2].grad is None


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper (sm_90) CUDA card; chip_smoke.py holds "
                    "the SSD backward kernel against its plain versions on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_bwd_matches_plain_versions(dtype, card):
    """Every SSD_SWEEP case and the zero-padded shapes (PADDED), with and
    without dh_final: the kernel's gradients against ref_ssd_bwd and
    autograd of ssd_chunked_plain on the same inputs (bf16 also against
    the emulation of its rounding), and a second call equal to the bit."""
    dt_ = getattr(torch, dtype)
    for case in SSD_SWEEP + PADDED:
        for final in (False, True):
            args, dy, dh = _inputs(case, seed=11)
            t = [_t(a, dt_ if i in (0, 3, 4) else torch.float32, card)
                 for i, a in enumerate(args)]
            gy, gh = _t(dy, dt_, card), _t(dh, device=card) if final \
                else None
            before = kops.ssd_scan_bwd.launches
            got = kops.ssd_scan_bwd(*t, gy, gh)
            again = kops.ssd_scan_bwd(*t, gy, gh)
            assert kops.ssd_scan_bwd.launches == before + 2
            for g, a in zip(got, again):
                assert torch.equal(g, a)
            _within(got, ref_ssd_bwd(*t, gy, gh), TOL_CARD_REF[dtype],
                    f"{case} ref")
            _within(got, _plain_grads(t, gy, gh, case[-1]), TOL_CARD[dtype],
                    f"{case} plain")
            if dtype == "bfloat16":
                _within(got, ref_ssd_bwd(
                    *(a.float() for a in t), gy.float(), gh,
                    round_bf16=True), TOL_CARD_EMU, f"{case} emulation")


@pytest.mark.cuda
def test_cuda_ssd_scan_bwd_refusals(card):
    args, dy, _ = _inputs((1, 64, 2, 16, 160, 16))
    x, dt, A, Bm, Cm = (_t(a, device=card) for a in args)
    with pytest.raises(ValueError):                 # N above 128
        kops.ssd_scan_bwd(x, dt, A, Bm, Cm, _t(dy, device=card))
    args, dy, _ = _inputs(SSD_SWEEP[0])
    x, dt, A, Bm, Cm = (_t(a, device=card) for a in args)
    with pytest.raises(TypeError):                  # dy not in x's dtype
        kops.ssd_scan_bwd(x, dt, A, Bm, Cm,
                          _t(dy, torch.bfloat16, card))
    with pytest.raises(TypeError):                  # A not f32
        kops.ssd_scan_bwd(x, dt, A.double(), Bm, Cm, _t(dy, device=card))
