"""The Mamba-2 block's causal depthwise conv with its SiLU.

On the CPU: the block's mixer (``models/ssm.py:_mix``) gives exactly what
its stack + einsum + bias + SiLU gave before the conv moved behind
``kernels.ops.causal_conv`` (the plain version, ``ref.ref_causal_conv``,
is those ops moved as they were), with and without bias, window and
``lengths``, at K in {2, 3, 4}; ``CausalConv``'s gradients on CPU tensors
(``ref.ref_causal_conv_bwd``, the gradient kernel's arithmetic) equal
autograd of the plain version; the wrapper refuses what the kernels do not
take; and a one-row call (the decode step) never reaches the wrapper.

The CUDA kernels run only on the card: the ``cuda``-marked tests below
hold them against their plain versions over ``ref.CONV_SWEEP`` (f32 and
bf16; the training shape as a view of the in-projection's output,
granite-4.0-h-small's prefill with bias and window, ragged lengths), check
that two calls give equal bits, and count a captured mamba2-130m train
step's launches.  This file imports no JAX.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_causal_conv.py
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ref import (CONV_SWEEP, CONV_TOL,  # noqa: E402
                                     ref_causal_conv, ref_causal_conv_bwd)
from repro_torch.models import ssm as TS  # noqa: E402

CC = sys.modules["repro_torch.kernels.causal_conv"]
H, P, N = 2, 8, 8                      # the mixer's widths in the CPU tests
D_INNER = H * P
DC = D_INNER + 2 * N
SIZES = [D_INNER, D_INNER, N, N, H]


def _mix_before(zxbcdt, dt_bias, w_conv, conv_state, sizes, b_conv=None,
                lengths=None):
    """``models/ssm.py:_mix`` as it was before the conv kernel, verbatim
    but for the einsum's promotion written out."""
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, sizes, dim=-1)
    dt = F.softplus(dt + dt_bias)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    B, S, dc = conv_in.shape
    K = w_conv.shape[-1]
    new_conv_state = None
    if conv_state is None:
        pad = torch.zeros((B, K - 1, dc), dtype=conv_in.dtype,
                          device=conv_in.device)
        ci = torch.cat([pad, conv_in], dim=1)
    else:
        ci = torch.cat([conv_state, conv_in], dim=1)
        if lengths is None:
            new_conv_state = ci[:, -(K - 1):]
        else:
            rows = lengths.long()[:, None] + torch.arange(
                K - 1, device=ci.device)
            new_conv_state = torch.gather(
                ci, 1, rows[..., None].expand(-1, -1, dc))
    if lengths is not None:
        real = torch.arange(S, device=dt.device) < lengths.long()[:, None]
        dt = dt * real[..., None].to(dt.dtype)
    win = torch.stack([ci[:, i:i + S] for i in range(K)], dim=-1)
    pt = torch.promote_types(win.dtype, w_conv.dtype)
    conv = torch.einsum("bsdk,dk->bsd", win.to(pt), w_conv.to(pt))
    if b_conv is not None:
        conv = conv + b_conv
    conv_out = F.silu(conv)
    return z, dt, conv_out, new_conv_state


def _rand(shape, dtype=torch.float32, seed=0, scale=1.0, device="cpu"):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _mixer_inputs(B, S, K, dtype, bias, state, seed=0):
    zx = _rand((B, S, 2 * D_INNER + 2 * N + H), dtype, seed)
    dt_bias = _rand((H,), dtype, seed + 1, 0.5)
    w = _rand((DC, K), dtype, seed + 2, 0.5)
    b = _rand((DC,), dtype, seed + 3, 0.2) if bias else None
    win = _rand((B, K - 1, DC), dtype, seed + 4) if state else None
    return zx, dt_bias, w, b, win


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", ["none", "window", "lengths"])
@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_mix_equals_the_stacked_einsum_exactly(K, bias, state, dtype):
    """Prefill-like (S 9), one row (the decode step) and, with lengths, a
    padded prefill whose rows end at 1, 5 and 9: every output of ``_mix``
    equal to the bit to what the stack + einsum gave."""
    dt_ = getattr(torch, dtype)
    for S in (9, 1):
        zx, dt_bias, w, b, win = _mixer_inputs(3, S, K, dt_, bias,
                                               state != "none")
        lengths = (torch.tensor([1, 5, S], dtype=torch.int32)
                   if state == "lengths" and S > 1 else None)
        got = TS._mix(zx, dt_bias, w, win, SIZES, b, lengths)
        want = _mix_before(zx, dt_bias, w, win, SIZES, b, lengths)
        for g, wt in zip(got, want):
            if wt is None:
                assert g is None
                continue
            assert g.dtype == wt.dtype and g.shape == wt.shape
            assert torch.equal(g, wt)


@pytest.mark.parametrize("window", [False, True], ids=["zeros", "window"])
@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_causal_conv_function_gradients_on_cpu(K, bias, window):
    """``CausalConv`` on CPU tensors (the wrappers' plain versions, the
    gradient from ``ref_causal_conv_bwd``) against autograd of the plain
    forward: float64 within 1e-12 and float32 within 1e-5 of each
    gradient's largest value.  The input is a strided view, as the model
    hands it; the window's gradient comes only where it is asked for."""
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        buf = _rand((2, 13, DC + 7), dtype, 5)
        x = buf[..., 3:3 + DC]
        w = _rand((DC, K), dtype, 6, 0.5)
        b = _rand((DC,), dtype, 7, 0.3) if bias else None
        win = _rand((2, K - 1, DC), dtype, 8) if window else None
        dy = _rand((2, 13, DC), dtype, 9)
        ins = [t if t is None else t.detach().clone().requires_grad_(True)
               for t in (x, w, b, win)]
        got = torch.autograd.grad((TS.CausalConv.apply(*ins) * dy).sum(),
                                  [t for t in ins if t is not None])
        ps = [t if t is None else t.detach().clone().requires_grad_(True)
              for t in (x, w, b, win)]
        want = torch.autograd.grad((ref_causal_conv(*ps) * dy).sum(),
                                   [t for t in ps if t is not None])
        for g, wt in zip(got, want):
            assert g.dtype == wt.dtype and g.shape == wt.shape
            scale = float(wt.abs().max())
            assert float((g - wt).abs().max()) <= tol * scale
        # the window's gradient only on request
        _, _, _, dwin = kops.causal_conv_bwd(x, w, b, win, dy)
        assert dwin is None
        if window:
            _, _, _, dwin = kops.causal_conv_bwd(x, w, b, win, dy,
                                                 want_window=True)
            assert torch.allclose(dwin, want[-1], rtol=0,
                                  atol=tol * float(want[-1].abs().max()))
        if window:
            frozen = ins[:3] + [win]
            g3 = torch.autograd.grad(
                (TS.CausalConv.apply(*frozen) * dy).sum(),
                [t for t in frozen[:3] if t is not None])
            for g, wt in zip(g3, got):
                assert torch.equal(g, wt)


def test_causal_conv_bwd_plain_is_f32_whatever_the_inputs():
    """bf16 inputs: the plain gradient computes in f32 and rounds once,
    returning each gradient in its input's dtype."""
    x = _rand((2, 10, DC), torch.bfloat16, 1)
    w = _rand((DC, 4), torch.bfloat16, 2, 0.5)
    b = _rand((DC,), torch.bfloat16, 3)
    win = _rand((2, 3, DC), torch.bfloat16, 4)
    dy = _rand((2, 10, DC), torch.bfloat16, 5)
    dx, dw, db, dwin = ref_causal_conv_bwd(x, w, b, win, dy,
                                           want_window=True)
    assert (dx.dtype, dw.dtype, db.dtype, dwin.dtype) == (torch.bfloat16,) * 4
    f = ref_causal_conv_bwd(x.float(), w.float(), b.float(), win.float(),
                            dy.float(), want_window=True)
    for g, wt in zip((dx, dw, db, dwin), f):
        assert torch.equal(g, wt.to(torch.bfloat16))


def test_wrapper_refuses_what_the_kernels_do_not_take():
    """What the CUDA branch refuses (``check_kernel_inputs``): K above 4,
    channels not at unit stride, mixed dtypes, float64; and on every
    device, mismatched shapes.  The plain versions take the first three;
    ``meta`` tensors run the plain version (shapes only)."""
    x = _rand((2, 6, DC))
    w = _rand((DC, 4), seed=1)
    CC.check_kernel_inputs(x, w)
    with pytest.raises(ValueError):                        # K above 4
        CC.check_kernel_inputs(x, _rand((DC, 5), seed=1))
    with pytest.raises(ValueError):                        # channel stride
        CC.check_kernel_inputs(_rand((2, 6, 2 * DC))[..., ::2], w)
    with pytest.raises(ValueError):                        # window's
        CC.check_kernel_inputs(x, w, None, _rand((2, DC, 3)).transpose(1, 2))
    with pytest.raises(ValueError):                        # dy's
        CC.check_kernel_inputs(x, w, dy=_rand((2, DC, 6)).transpose(1, 2))
    with pytest.raises(TypeError):                         # mixed dtypes
        CC.check_kernel_inputs(x.bfloat16(), w)
    with pytest.raises(TypeError):
        CC.check_kernel_inputs(x, w, _rand((DC,)).bfloat16())
    with pytest.raises(TypeError):
        CC.check_kernel_inputs(x, w, dy=x.bfloat16())
    with pytest.raises(TypeError):                         # float64
        CC.check_kernel_inputs(x.double(), w.double())
    # the plain version takes them
    y = kops.causal_conv(x, _rand((DC, 5), seed=1))
    assert y.shape == x.shape
    # shapes, on every device
    with pytest.raises(ValueError):
        kops.causal_conv(x, w[:5])
    with pytest.raises(ValueError):
        kops.causal_conv(x, w, _rand((DC + 1,)))
    with pytest.raises(ValueError):
        kops.causal_conv(x, w, None, _rand((2, 2, DC)))
    with pytest.raises(ValueError):
        kops.causal_conv_bwd(x, w, None, None, x[:, :3])
    with pytest.raises(ValueError):                        # two devices
        kops.causal_conv(x, w.to("meta"))
    y = kops.causal_conv(x.to("meta"), w.to("meta"))
    assert (y.device.type, y.shape, y.dtype) == ("meta", x.shape, x.dtype)


@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
def test_one_row_mix_never_reaches_the_wrapper(grad, monkeypatch):
    """The decode step (S == 1) runs the plain ops in ``_mix`` itself: the
    wrapper is not called and its launch counter stays 0; a call of more
    rows goes through the wrapper once (on the CPU, to its plain
    version)."""
    calls = []
    real = kops.causal_conv

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(kops, "causal_conv", counted)
    monkeypatch.setattr(TS.CausalConv, "apply",
                        lambda *a: pytest.fail("CausalConv on the CPU"))
    launches = real.launches
    for S, want in ((1, 0), (4, 1)):
        calls.clear()
        zx, dt_bias, w, b, win = _mixer_inputs(2, S, 4, torch.float32, True,
                                               True)
        if grad:
            zx.requires_grad_(True)
            w.requires_grad_(True)
        with torch.set_grad_enabled(grad):
            TS._mix(zx, dt_bias, w, win, SIZES, b, None)
        assert len(calls) == want
    assert real.launches == launches == 0


def test_conv_sweep_covers_the_path_shapes():
    """The card's sweep holds the training view, granite's prefill with
    bias and window, a length that is no multiple of a CTA's rows, and
    views that take the masked (not 16-byte) accesses."""
    shapes = {(c[0], c[1], c[2]) for c in CONV_SWEEP}
    assert (16, 2048, 1792) in shapes and (1, 6720, 8448) in shapes
    assert any(c[1] % CC.BWD_ROWS and c[1] > CC.BWD_ROWS for c in CONV_SWEEP)
    assert any(c[4] * 2 % 16 or c[2] % 8 for c in CONV_SWEEP)
    assert {c[3] for c in CONV_SWEEP} >= {2, 3, 4}
    assert set(CONV_TOL) == {"float32", "bfloat16"}


def test_first_use_builds_the_conv_beside_the_ssd_scan(monkeypatch):
    """The Mamba-2 block runs both sources: the first use of either builds
    the two at once (one nvcc each, in parallel), so a fresh checkout's
    first set-up waits for the longer build, not their sum."""
    from repro_torch.kernels import build
    built = []
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build_all", lambda names: built.append(
        tuple(names)))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    build.library("causal_conv")
    build.library("ssd_scan")
    build.library("rmsnorm")
    assert built == [("causal_conv", "ssd_scan"), ("ssd_scan", "causal_conv"),
                     ("rmsnorm",)]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper (sm_90) CUDA card; chip_smoke.py holds "
                    "the causal_conv kernels against their plain versions "
                    "on the card")
    return torch.device("cuda")


def conv_case(case, dtype, device, seed=0):
    """(x, w, b, window, dy) of a CONV_SWEEP case: x a view of its
    columns in a [B, S, width] buffer."""
    B, S, dc, K, width, off, bias, window = case
    buf = _rand((B, S, width), dtype, seed, device=device)
    x = buf[..., off:off + dc]
    w = _rand((dc, K), dtype, seed + 1, 0.5, device)
    b = _rand((dc,), dtype, seed + 2, 0.3, device) if bias else None
    win = _rand((B, K - 1, dc), dtype, seed + 3, device=device) \
        if window else None
    dy = _rand((B, S, dc), dtype, seed + 4, device=device)
    return x, w, b, win, dy


def _rel(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_causal_conv_matches_plain_versions(dtype, card):
    """Every CONV_SWEEP case: the forward against ``ref_causal_conv``
    (bf16: against the plain version in f32, rounded once, and against the
    bf16 plain version), the gradient (dx, dw, db, dwindow) against
    ``ref_causal_conv_bwd`` and, in f32, autograd of the plain forward; a
    second call of each equal to the bit."""
    dt_ = getattr(torch, dtype)
    tol = CONV_TOL[dtype]
    for case in CONV_SWEEP:
        x, w, b, win, dy = conv_case(case, dt_, card)
        f = [t if t is None else t.float() for t in (x, w, b, win, dy)]
        n0 = kops.causal_conv.launches
        y = kops.causal_conv(x, w, b, win)
        assert torch.equal(y, kops.causal_conv(x, w, b, win))
        assert kops.causal_conv.launches == n0 + 2
        assert y.dtype == dt_ and y.is_contiguous()
        # f32: the plain version in f32; bf16: it in f32, rounded once
        assert _rel(y, ref_causal_conv(*f[:4]).to(dt_)) <= tol, case
        assert _rel(y, ref_causal_conv(x, w, b, win)) <= tol, case
        n1 = kops.causal_conv_bwd.launches
        got = kops.causal_conv_bwd(x, w, b, win, dy,
                                   want_window=win is not None)
        again = kops.causal_conv_bwd(x, w, b, win, dy,
                                     want_window=win is not None)
        assert kops.causal_conv_bwd.launches == n1 + 2
        want = ref_causal_conv_bwd(*f, want_window=win is not None)
        for name, g, a, wt in zip(("dx", "dw", "db", "dwin"), got, again,
                                  want):
            if wt is None:
                assert g is None
                continue
            assert torch.equal(g, a), (case, name)
            assert g.dtype == dt_
            assert _rel(g, wt) <= tol, (case, name, _rel(g, wt))
        if dtype == "float32" and case[0] * case[1] * case[2] <= 8e6:
            ps = [t if t is None else t.detach().clone().requires_grad_(True)
                  for t in (x, w, b, win)]
            auto = torch.autograd.grad((ref_causal_conv(*ps) * dy).sum(),
                                       [t for t in ps if t is not None])
            for g, wt in zip([g for g in got if g is not None], auto):
                assert _rel(g, wt) <= 1e-4, case
        del x, w, b, win, dy, f, got, again, want
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_causal_conv_refusals(card):
    x, w, b, win, dy = conv_case(CONV_SWEEP[3], torch.float32, card)
    with pytest.raises(ValueError):                        # K above 4
        kops.causal_conv(x, torch.ones((x.shape[-1], 5), device=card))
    with pytest.raises(TypeError):                         # mixed dtypes
        kops.causal_conv(x, w.bfloat16())
    with pytest.raises(ValueError):                        # channel stride
        kops.causal_conv(torch.ones((2, 2, 512), device=card)[..., ::2], w)
    with pytest.raises(TypeError):
        kops.causal_conv_bwd(x, w, b, win, dy.bfloat16())


@pytest.mark.cuda
def test_cuda_mix_routes_by_rows_and_autograd(card, monkeypatch):
    """On the card ``_mix`` launches the conv kernel for more than one row
    (through ``CausalConv`` under autograd: one forward and, backward, one
    gradient launch, no plain version) and leaves the one-row decode step
    to the plain ops (no launch)."""
    zx, dt_bias, w, b, win = (t if t is None else t.to(card) for t in
                              _mixer_inputs(2, 1, 4, torch.float32, True,
                                            True))
    n0 = kops.causal_conv.launches
    TS._mix(zx, dt_bias, w, win, SIZES, b, None)
    assert kops.causal_conv.launches == n0
    zx, dt_bias, w, b, win = (t if t is None else t.to(card) for t in
                              _mixer_inputs(2, 40, 4, torch.float32, True,
                                            False))
    zx.requires_grad_(True)
    w.requires_grad_(True)

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(CC, "ref_causal_conv", plain)
    monkeypatch.setattr(CC, "ref_causal_conv_bwd", plain)
    n1 = kops.causal_conv_bwd.launches
    _, _, out, _ = TS._mix(zx, dt_bias, w, None, SIZES, b, None)
    assert kops.causal_conv.launches == n0 + 1
    gz, gw = torch.autograd.grad(out.sum(), [zx, w])
    assert kops.causal_conv_bwd.launches == n1 + 1
    assert gz.shape == zx.shape and gw.shape == w.shape


@pytest.mark.cuda
def test_cuda_captured_train_step_counts_conv_launches(card):
    """mamba2-130m at published width and 24 layers (bf16, remat full),
    trained through co-execution on 2 x 128 tokens: once the step is
    captured, each replayed step launches the conv kernel 48 times (24
    layers, forward and remat recompute) and its gradient 24 times."""
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer
    cfg = get_config("mamba2-130m")
    assert cfg.n_layers == 24 and cfg.remat
    tr = Trainer(cfg, OptConfig(), ckpt_dir=None, batch=2, seq_len=128,
                 use_terra=True, device="cuda")
    it = tr._iteration
    rng = np.random.default_rng(0)

    def step():
        t = rng.integers(0, cfg.vocab, size=(2, 129), dtype=np.int32)
        return it(t[:, :-1].copy(), t[:, 1:].copy())
    try:
        for _ in range(3):                  # trace, warm up, capture
            step()
        it.wait()
        f0 = kops.causal_conv.launches
        b0 = kops.causal_conv_bwd.launches
        for _ in range(2):
            loss, _ = step()
        it.wait()
        assert it.engine.capture.stats["replays"] >= 2
        assert kops.causal_conv.launches - f0 == 48 * 2
        assert kops.causal_conv_bwd.launches - b0 == 24 * 2
        assert np.isfinite(float(loss))
    finally:
        it.close()
