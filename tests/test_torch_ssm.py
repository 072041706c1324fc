"""The port's Mamba-2 SSD path against the JAX reference.

The SSD-scan entry point (``repro_torch.kernels.ops.ssd_scan``) and the
port's ``ref_ssd`` are held against the reference's Pallas kernel in
interpret mode and its sequential ``ref_ssd`` over
``tests/test_kernels.py``'s SSD sweep, a prime length and a length below
the chunk (1e-4 f32, 5e-2 bf16).  On the CPU the wrapper runs its plain
version, because a CPU tensor means the caller asked for the CPU.
``models/ssm.py`` (the chunked math, the decode step and the whole block)
and the smoke mamba2-130m model are held against the reference's
functions on numpy-seeded inputs and converted reference params.  The
CUDA kernel runs only on the card: the ``cuda``-marked test below holds
it against its plain versions there and skips elsewhere, and
``chip_smoke.py`` does the same at the serving shapes.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssm.py
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ref import SSD_SWEEP, ref_ssd  # noqa: E402
from repro_torch.kernels.ref import ssd_chunk_parallel  # noqa: E402
from repro_torch.kernels.ref import SSD_TOL as TOL_SSD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL_CHUNKED = 2e-4
TOL_GRAD = 1e-4
# one chunk, a prime length, N 128 over 3 chunks, P 128 with a ragged chunk
GRAD_CASES = [SSD_SWEEP[i] for i in (0, 4, 9, 11)]
TOL_MODEL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def jax_ref():
    """(jax, jax.numpy), with JAX on the CPU as the reference's own tests
    run it (interpret-mode Pallas)."""
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


@pytest.fixture(scope="module")
def mamba(jax_ref):
    jax, _ = jax_ref
    from repro.configs import smoke_config as j_smoke
    from repro.models import model as JM
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"), **F32)
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"), **F32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _ssd_inputs(case, seed=1):
    """x, dt (softplus(randn) * 0.1), A (-exp(randn * 0.3)), Bm, Cm as
    float32 numpy arrays, the reference test's distributions."""
    B, S, H, P, N, _ = case
    r = np.random.RandomState(seed)
    x = r.randn(B, S, H, P).astype(np.float32)
    dt = (np.log1p(np.exp(r.randn(B, S, H))) * 0.1).astype(np.float32)
    A = (-np.exp(r.randn(H) * 0.3)).astype(np.float32)
    Bm = r.randn(B, S, N).astype(np.float32)
    Cm = r.randn(B, S, N).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(a, dtype="float32", device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _typed(arrs, dtype, device="cpu"):
    """x, Bm, Cm in ``dtype``; dt and A float32 (tests/test_kernels.py)."""
    x, dt, A, Bm, Cm = arrs
    return (_t(x, dtype, device), _t(dt, "float32", device),
            _t(A, "float32", device), _t(Bm, dtype, device),
            _t(Cm, dtype, device))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_SWEEP)
def test_ssd_scan_matches_reference_kernel_and_ref(case, dtype, jax_ref):
    _, jnp = jax_ref
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    arrs = _ssd_inputs(case)
    jx = [jnp.asarray(a) for a in arrs]
    for i in (0, 3, 4):
        jx[i] = jx[i].astype(dtype)
    want_kernel = jops.ssd_scan(*jx, chunk=case[-1])
    want_ref = jref.ref_ssd(*jx)
    kops.ssd_scan.launches = 0
    t = _typed(arrs, dtype)
    got, h = kops.ssd_scan(*t, chunk=case[-1], return_final=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == t[0].shape
    assert h.dtype == torch.float32 and h.shape == (case[0], case[2],
                                                    case[3], case[4])
    tol = TOL_SSD[dtype]
    for want in (want_kernel, want_ref):
        _close(got, want, tol)
        _close(ref_ssd(*t), want, tol)
    assert kops.ssd_scan.launches == 0             # the CPU launches nothing


@pytest.mark.parametrize("Q", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_SWEEP)
def test_ssd_chunk_parallel_emulation_matches_reference(case, dtype, Q,
                                                        jax_ref):
    """The kernels' decomposition (chunk pass, state pass, output pass) at
    the kernels' chunks, exact in f32 and with the bf16 kernels' rounding
    points in bf16, against the reference's Pallas kernel in interpret mode
    and the sequential recurrence, for y and the final state; no NaN (L is
    taken on the lower triangle only)."""
    _, jnp = jax_ref
    from repro.kernels import ops as jops
    arrs = _ssd_inputs(case)
    jx = [jnp.asarray(a) for a in arrs]
    for i in (0, 3, 4):
        jx[i] = jx[i].astype(dtype)
    want_kernel = jops.ssd_scan(*jx, chunk=case[-1])
    t = _typed(arrs, dtype)
    want_y, want_h = ref_ssd(*t, return_final=True)
    got, h = ssd_chunk_parallel(*t, chunk=Q, return_final=True,
                                round_bf16=dtype == "bfloat16")
    assert got.dtype == t[0].dtype and h.dtype == torch.float32
    assert not torch.isnan(got.float()).any() and not torch.isnan(h).any()
    tol = TOL_SSD[dtype]
    _close(got, want_kernel, tol)
    _close(got, want_y, tol)
    _close(h, want_h, tol)


def test_ssd_scan_plan_and_scratch():
    """Chunks, head groups and scratch at the main path's shapes: the
    prefill [1, 1024] runs 16 chunks x 24 heads in CTAs of one head, the
    eval forward [4, 2048] 32 chunks x 3 groups of 8 heads x 4."""
    SS = sys.modules["repro_torch.kernels.ssd_scan"]
    bf16 = torch.bfloat16
    assert SS.CHUNK == 64
    assert SS.plan(1, 1024, 24) == (16, 1)
    assert SS.plan(4, 2048, 24) == (32, 8)
    assert SS.plan(1, 1, 24) == (1, 1)
    assert SS.plan(1, 65, 2) == (2, 1)
    assert SS.plan(64, 640, 3) == (10, 3)       # one group: 640 CTAs
    # f32 chunk states + decays, bf16 hi + lo carried states: 25.2 MB at
    # the prefill with Q = 64
    assert SS.scratch_bytes(1, 1024, 24, 64, 128, True, bf16) == \
        4 * 16 * 24 * (64 * 128 + 1) + 4 * 16 * 24 * 64 * 128
    assert SS.scratch_bytes(1, 1024, 24, 64, 128, True, torch.float32) == \
        4 * 16 * 24 * (64 * 128 + 1)
    assert SS.scratch_bytes(1, 64, 24, 64, 128, False, bf16) == 0
    assert SS.scratch_bytes(1, 64, 24, 64, 128, True, bf16) == \
        4 * 24 * (64 * 128 + 1)


def test_ssd_scan_16_byte_loads_read_conv_slices():
    """x, B and C as the model hands them over (slices of the conv output,
    rows 1792 elements apart) take 16-byte loads; a view one element off,
    or N not in 16-byte units, does not."""
    SS = sys.modules["repro_torch.kernels.ssd_scan"]
    conv = torch.zeros(2, 64, 24 * 64 + 2 * 128, dtype=torch.bfloat16)
    x = conv[..., :1536].reshape(2, 64, 24, 64)
    Bm, Cm = conv[..., 1536:1664], conv[..., 1664:]
    assert SS._vec_ok(x, Bm, Cm, 128)
    assert not SS._vec_ok(x, conv[..., 1537:1665], Cm, 128)
    odd = torch.zeros(2, 64, 24 + 2 * 12, dtype=torch.bfloat16)
    assert not SS._vec_ok(odd[..., :24].reshape(2, 64, 2, 12),
                          odd[..., 24:36], odd[..., 36:], 12)


@pytest.mark.parametrize("return_final", [False, True],
                         ids=["y", "y+h_final"])
@pytest.mark.parametrize("case", SSD_SWEEP)
def test_ssd_chunked_matches_reference(case, return_final, jax_ref):
    _, jnp = jax_ref
    from repro.models import ssm as JS
    arrs = _ssd_inputs(case, seed=3)
    chunk = case[-1]
    want = JS.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk,
                          return_final=return_final)
    got = TS.ssd_chunked(*(_t(a) for a in arrs), chunk,
                         return_final=return_final)
    if not return_final:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        _close(g, w, TOL_CHUNKED)
    # the two plain versions agree: chunked math and the recurrence
    seq = ref_ssd(*(_t(a) for a in arrs), return_final=True)
    for g, w in zip(got, seq):
        _close(g, w, TOL_CHUNKED)


def test_ssd_chunked_bf16_dtype_flow(jax_ref):
    """bf16 x/B/C and bf16 dt (the model path's types): mixed products
    promote as in jnp; y comes back bf16, the final state f32."""
    _, jnp = jax_ref
    from repro.models import ssm as JS
    arrs = _ssd_inputs((2, 48, 2, 16, 16, 16), seed=4)
    jx = [jnp.asarray(a) for a in arrs]
    tx = [_t(a) for a in arrs]
    for i in (0, 1, 3, 4):
        jx[i] = jx[i].astype("bfloat16")
        tx[i] = tx[i].to(torch.bfloat16)
    wy, wh = JS.ssd_chunked(*jx, 16, return_final=True)
    gy, gh = TS.ssd_chunked(*tx, 16, return_final=True)
    assert gy.dtype == torch.bfloat16 and gh.dtype == torch.float32
    _close(gy, wy, TOL_SSD["bfloat16"])
    _close(gh, wh, TOL_SSD["bfloat16"])


def test_ssd_decode_step_matches_reference(jax_ref):
    _, jnp = jax_ref
    from repro.models import ssm as JS
    r = np.random.RandomState(5)
    B, H, P, N = 3, 4, 16, 16
    state = r.randn(B, H, P, N).astype(np.float32)
    x = r.randn(B, H, P).astype(np.float32)
    dt = (np.log1p(np.exp(r.randn(B, H))) * 0.1).astype(np.float32)
    A = (-np.exp(r.randn(H) * 0.3)).astype(np.float32)
    Bm, Cm = (r.randn(B, N).astype(np.float32) for _ in range(2))
    args = (state, x, dt, A, Bm, Cm)
    wy, ws = JS.ssd_decode_step(*(jnp.asarray(a) for a in args))
    gy, gs = TS.ssd_decode_step(*(_t(a) for a in args))
    _close(gy, wy, TOL_MODEL)
    _close(gs, ws, TOL_MODEL)


@pytest.mark.parametrize("mode", ["no-cache", "prefill", "decode"])
def test_mamba2_block_matches_reference(mamba, mode, jax_ref):
    jax, jnp = jax_ref
    from repro.models import ssm as JS
    jcfg, tcfg, jp, tp = mamba
    S = 1 if mode == "decode" else 19
    r = np.random.RandomState(6)
    x = r.randn(2, S, jcfg.d_model).astype(np.float32)
    p_j = jax.tree.map(lambda a: a[0], jp["blocks"][0]["ssd"])
    p_t = {k: v[0] for k, v in tp["blocks"][0]["ssd"].items()}
    jc = tc = None
    if mode != "no-cache":
        dc = jcfg.ssm_heads * jcfg.ssm_head_dim + 2 * jcfg.ssm_state
        conv = r.randn(2, jcfg.conv_kernel - 1, dc).astype(np.float32)
        st = r.randn(2, jcfg.ssm_heads, jcfg.ssm_head_dim,
                     jcfg.ssm_state).astype(np.float32)
        jc = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(st)}
        tc = {"conv": _t(conv), "ssm": _t(st)}
    want, wcache = JS.mamba2_block(p_j, jnp.asarray(x), jcfg, cache=jc)
    got, gcache = TS.mamba2_block(p_t, _t(x), tcfg, cache=tc)
    _close(got, want, TOL_MODEL)
    if mode == "no-cache":
        assert gcache is None and wcache is None
    else:
        _close(gcache["conv"], wcache["conv"], TOL_MODEL)
        _close(gcache["ssm"], wcache["ssm"], TOL_MODEL)


def test_mamba2_forward_prefill_decode_match_reference(mamba, jax_ref):
    """Forward logits against the reference's; prefill then greedy
    decode reproduces the forward's greedy tokens."""
    _, jnp = jax_ref
    from repro.models import model as JM
    jcfg, tcfg, jp, tp = mamba
    ids = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 23)).astype(
        np.int32)
    got = TM.forward(tcfg, tp, torch.from_numpy(ids))
    _close(got, JM.forward(jcfg, jp, jnp.asarray(ids)), TOL_MODEL)
    # greedy continuation: prefill 12 tokens, decode the rest one by one,
    # feeding the forward's own tokens; each step's logits equal the
    # forward's at that position
    P0 = 12
    logits, cache = TM.prefill(tcfg, tp, torch.from_numpy(ids[:, :P0]), 64)
    _close(logits, got[:, P0 - 1], TOL_MODEL)
    for t in range(P0, ids.shape[1]):
        logits, cache = TM.decode_step(tcfg, tp, cache,
                                       torch.from_numpy(ids[:, t:t + 1]))
        _close(logits, got[:, t], TOL_MODEL)
    assert cache["len"] == ids.shape[1]
    np.testing.assert_array_equal(
        logits.argmax(-1).numpy(), got[:, -1].argmax(-1).numpy())


def test_ssd_scan_rejects_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = _typed(_ssd_inputs(SSD_SWEEP[0]), "float32")
    with pytest.raises(ValueError):
        kops.ssd_scan(x[0], dt, A, Bm, Cm)                   # not 4-d
    with pytest.raises(ValueError):
        kops.ssd_scan(x, dt[:, :5], A, Bm, Cm)               # dt shape
    with pytest.raises(ValueError):
        kops.ssd_scan(x, dt, A[:1], Bm, Cm)                  # A shape
    with pytest.raises(ValueError):
        kops.ssd_scan(x, dt, A, Bm, Cm[..., :8])             # B/C shapes
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm)]
    with pytest.raises(NotImplementedError):
        kops.ssd_scan(*meta)
    # the model function runs the chunked math on meta tensors (shapes
    # only: the dry run), never the kernel
    y = TS.ssd_chunked(*meta, 16)
    assert (y.device.type, y.shape, y.dtype) == ("meta", x.shape, x.dtype)


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper (sm_90) CUDA card; chip_smoke.py holds "
                    "the SSD kernel against its plain versions on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_matches_plain_versions(dtype, card):
    """Every case against the recurrence, the chunked math and the
    kernels' own decomposition (``ssd_chunk_parallel`` with the bf16
    kernels' operand rounding); the call without the final state gives
    the same y."""
    SS = sys.modules["repro_torch.kernels.ssd_scan"]
    for case in SSD_SWEEP:
        t = _typed(_ssd_inputs(case), dtype, card)
        before = kops.ssd_scan.launches
        y, h = kops.ssd_scan(*t, chunk=case[-1], return_final=True)
        wy, wh = ref_ssd(*t, return_final=True)
        tol = dict(rtol=TOL_SSD[dtype], atol=TOL_SSD[dtype])
        torch.testing.assert_close(y.float(), wy.float(), **tol)
        torch.testing.assert_close(h, wh, **tol)
        cy = TS.ssd_chunked_plain(*t, case[-1])
        torch.testing.assert_close(y.float(), cy.float(), **tol)
        ey, eh = ssd_chunk_parallel(*t, chunk=SS.CHUNK, return_final=True,
                                    round_bf16=dtype == "bfloat16")
        torch.testing.assert_close(y.float(), ey.float(), **tol)
        torch.testing.assert_close(h, eh, **tol)
        assert not torch.isnan(y.float()).any()
        y2 = kops.ssd_scan(*t, chunk=case[-1])       # no final state
        torch.testing.assert_close(y2, y, rtol=0, atol=0)
        assert kops.ssd_scan.launches == before + 2


def test_ssd_chunked_differentiates_the_plain_math_on_the_cpu():
    """CPU training differentiates the chunked math: a gradient reaches
    every input."""
    case = SSD_SWEEP[0]
    t = [a.requires_grad_(a.is_floating_point())
         for a in _typed(_ssd_inputs(case), "float32")]
    y = TS.ssd_chunked(*t, case[-1])
    gs = torch.autograd.grad(y.square().sum(), t)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in gs)


@pytest.mark.parametrize("return_final", [False, True],
                         ids=["y", "y+h_final"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_ssd_scan_function_gradients_match_reference(case, return_final,
                                                     jax_ref):
    """``SSDScan`` (the kernel's forward, the plain chunked math's
    gradients) on the CPU path — its forward is the kernel's plain
    version there — against the reference's ``jax.grad`` of
    ``ssd_chunked``, every input, f32, within TOL_GRAD relative to each
    gradient's largest value."""
    jax, jnp = jax_ref
    from repro.models import ssm as JS
    arrs = _ssd_inputs(case, seed=5)
    chunk = case[-1]
    r = np.random.RandomState(6)
    wy = r.randn(*arrs[0].shape).astype(np.float32)
    wh = r.randn(case[0], case[2], case[3], case[4]).astype(np.float32)

    def j_loss(*xs):
        out = JS.ssd_chunked(*xs, chunk, return_final=return_final)
        if return_final:
            return jnp.sum(out[0] * wy) + jnp.sum(out[1] * wh)
        return jnp.sum(out * wy)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrs))
    xs = [_t(a).requires_grad_(True) for a in arrs]
    out = TS.SSDScan.apply(*xs, chunk, return_final)
    loss = ((out[0] * _t(wy)).sum() + (out[1] * _t(wh)).sum()
            if return_final else (out * _t(wy)).sum())
    got = torch.autograd.grad(loss, xs)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert np.abs(g.numpy() - w).max() <= TOL_GRAD * scale


@pytest.mark.cuda
def test_cuda_ssd_chunked_raises_under_autograd(card, monkeypatch):
    """(Name kept from when the kernel had no backward and this raised.)
    On the card a call that autograd differentiates goes through
    ``SSDScan``: the forward launches the SSD-scan kernel once and
    matches the no-grad kernel call exactly; the backward launches the
    gradient kernel once and calls no plain version (``ssd_chunked_plain``
    and ``ref_ssd_bwd`` raise while it runs); its gradients of every
    input equal all-plain autograd of ``ssd_chunked_plain`` within f32
    1e-4 and bf16 5e-2 of the largest value."""
    SS = sys.modules["repro_torch.kernels.ssd_scan"]
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 5e-2)):
        case = SSD_SWEEP[0]
        t = _typed(_ssd_inputs(case), dtype, card)
        xs = [a.clone().requires_grad_(True) for a in t]
        before = kops.ssd_scan.launches
        bwd = kops.ssd_scan_bwd.launches
        y = TS.ssd_chunked(*xs, case[-1])
        assert kops.ssd_scan.launches == before + 1
        with torch.no_grad():
            y0 = TS.ssd_chunked(*t, case[-1])
        torch.testing.assert_close(y, y0, rtol=0, atol=0)
        w = torch.randn(y.shape, generator=torch.Generator(card)
                        .manual_seed(0), device=card).to(y.dtype)

        def plain(*a, **k):
            raise AssertionError("a plain version ran on the card")
        with monkeypatch.context() as m:
            m.setattr(TS, "ssd_chunked_plain", plain)
            m.setattr(SS, "ref_ssd_bwd", plain)
            got = torch.autograd.grad((y.float() * w.float()).sum(), xs)
        assert kops.ssd_scan.launches == before + 2
        assert kops.ssd_scan_bwd.launches == bwd + 1
        ps = [a.clone().requires_grad_(True) for a in t]
        yp = TS.ssd_chunked_plain(*ps, case[-1])
        want = torch.autograd.grad((yp.float() * w.float()).sum(), ps)
        for g, wg in zip(got, want):
            assert g.dtype == wg.dtype
            scale = wg.float().abs().max()
            assert (g.float() - wg.float()).abs().max() <= tol * scale
