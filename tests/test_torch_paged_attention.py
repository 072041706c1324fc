"""The port's paged-attention decode against the JAX reference.

On the CPU the port's wrapper runs its plain version (a CPU tensor means
the caller asked for the CPU); it is held against the reference's dense
oracle (``repro.kernels.ref.ref_paged_attention``) and against the Pallas
kernel in interpret mode (``repro.kernels.ops.paged_attention``), on the
same numpy-seeded inputs.  The CUDA kernel itself runs only on the card:
``chip_smoke.py`` holds it against the plain version there, and the one
test below that needs the card (marker ``cuda``) skips elsewhere.  The
reference is imported by a fixture, so this file also collects on the
card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_attention.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    ATTN_TOL, PAGED_LONG, PAGED_SERVING, PAGED_SWEEP, PAGED_WINDOWS,
    ref_paged_attention)

TOL = ATTN_TOL


@pytest.fixture(scope="module")
def jax_ref():
    """(jax.numpy, repro.kernels.ops, repro.kernels.ref), with JAX on the
    CPU as the reference's own tests run it (interpret-mode Pallas, full
    f32 matmuls)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the reference comparisons run with JAX on the CPU")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(B, Hq, Hkv, D, bs, nbps, nblocks, valid, seed):
    """Distinct real blocks for each row's valid positions, trash block 0
    in every tail entry."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, Hq, D).astype(np.float32)
    kp = rng.randn(nblocks, bs, Hkv, D).astype(np.float32)
    vp = rng.randn(nblocks, bs, Hkv, D).astype(np.float32)
    bt = np.zeros((B, nbps), np.int32)
    ids = rng.permutation(np.arange(1, nblocks))
    off = 0
    for b, v in enumerate(valid):
        n = -(-v // bs)
        bt[b, :n] = ids[off:off + n]
        off += n
    return q, kp, vp, bt, np.asarray(valid, np.int32)


SHAPES = PAGED_SWEEP


def _shape_id(s):
    return f"G{s[2]}-D{s[3]}" + (f"-bs{s[4]}-nbps{s[5]}" if s[5] != 4 else "")


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _port(q, kp, vp, bt, vl, dtype, window):
    tdt = getattr(torch, dtype)
    before = PA.paged_attention.launches
    out = PA.paged_attention(_torch(q, tdt), _torch(kp, tdt),
                             _torch(vp, tdt), torch.from_numpy(bt),
                             torch.from_numpy(vl), window=window)
    assert PA.paged_attention.launches == before      # CPU: no launch
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    return out.float().numpy()


def _jax_in(jnp, q, kp, vp, bt, vl, dtype):
    jdt = jnp.dtype(dtype)
    return [jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(bt), jnp.asarray(vl)]


@pytest.mark.parametrize("window", PAGED_WINDOWS)
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(jax_ref, shape, window, dtype):
    jnp, _, jref = jax_ref
    B, Hkv, G, D, bs, nbps, nblocks, valid = shape
    x = _inputs(B, Hkv * G, Hkv, D, bs, nbps, nblocks, valid,
                seed=G + window)
    got = _port(*x, dtype, window)
    oracle = np.asarray(jref.ref_paged_attention(*_jax_in(jnp, *x, dtype),
                                                 window=window), np.float32)
    np.testing.assert_allclose(got, oracle, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: f"G{s[2]}")
def test_plain_matches_interpret_mode_kernel(jax_ref, shape, window):
    """The Pallas kernel as the reference's own tests run it off-TPU."""
    jnp, jops, _ = jax_ref
    B, Hkv, G, D, bs, nbps, nblocks, valid = shape
    x = _inputs(B, Hkv * G, Hkv, D, bs, nbps, nblocks, valid,
                seed=G + window)
    got = _port(*x, "float32", window)
    kernel = np.asarray(jops.paged_attention(*_jax_in(jnp, *x, "float32"),
                                             window=window), np.float32)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [0, 6])
def test_plain_matches_interpret_mode_kernel_at_d80(jax_ref, window):
    """A head dim between the instantiated ones (the card runs it in the
    D = 128 kernels, the arena read as it is, its extra columns masked):
    the plain version against the Pallas kernel in interpret mode."""
    jnp, jops, _ = jax_ref
    shape = next(s for s in SHAPES if s[3] == 80)
    B, Hkv, G, D, bs, nbps, nblocks, valid = shape
    x = _inputs(B, Hkv * G, Hkv, D, bs, nbps, nblocks, valid, seed=80)
    got = _port(*x, "float32", window)
    kernel = np.asarray(jops.paged_attention(*_jax_in(jnp, *x, "float32"),
                                             window=window), np.float32)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, kp, vp, bt, vl = _inputs(2, 4, 2, 16, 8, 2, 5, [3, 9], seed=0)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, vl)]
    with pytest.raises(ValueError):
        PA.paged_attention(args[0][:, :, :3], *args[1:])   # Hq % Hkv != 0
    with pytest.raises(ValueError):
        PA.paged_attention(args[0], args[1][..., :8], args[2][..., :8],
                           *args[3:])                        # head dim
    with pytest.raises(ValueError):
        PA.paged_attention(*args, window=-1)
    with pytest.raises(ValueError):
        PA.paged_attention(args[0][:, 0], *args[1:])         # not [B,1,H,D]


def test_padded_group_mirrors_the_kernels_instantiations():
    """Every group up to 16 runs: the registry's and 2 in their own
    instantiation, any other padded to 4, 8 or 16 rows; past 16 (or 0)
    the wrapper raises, naming the group."""
    want = {1: 1, 2: 2, 3: 4, 4: 4, 5: 5, 6: 6, 7: 8, 8: 8, 9: 16, 10: 10,
            11: 16, 12: 16, 13: 16, 14: 16, 15: 16, 16: 16}
    assert {g: PA.padded_group(g) for g in range(1, 17)} == want
    for g in (0, 17, 32):
        with pytest.raises(ValueError, match=str(g)):
            PA.padded_group(g)


def split_k(q, kp, vp, bt, vl, window=0):
    """The kernel's split-K decomposition in plain f32 torch, with the
    wrapper's own split plan: per split (m, l, acc) over its live blocks
    (masked positions -1e30), an empty split (m = -inf, l = 0), then the
    combine M = max m_s, w_s = exp(m_s - M) (0 when empty), O = sum w_s
    acc_s / sum w_s l_s.  Returns (out, number of empty splits)."""
    B, _, Hq, D = q.shape
    bs, Hkv, nbps = kp.shape[1], kp.shape[2], bt.shape[1]
    G = Hq // Hkv
    nsplit, bps = PA.split_plan(B, Hkv, nbps, bs)
    qs = q.float().reshape(B, Hkv, G, D) * D ** -0.5
    out = torch.zeros(B, Hkv, G, D)
    empty = 0
    for b in range(B):
        v = int(vl[b])
        j_hi = min(-(-v // bs), nbps)
        j_lo = (v - window) // bs if window and v - window > 0 else 0
        ms, ls, accs = [], [], []
        for s in range(nsplit):
            j0, j1 = max(s * bps, j_lo), min((s + 1) * bps, j_hi)
            if j0 >= j1:
                empty += 1
                ms.append(torch.full((Hkv, G), -torch.inf))
                ls.append(torch.zeros(Hkv, G))
                accs.append(torch.zeros(Hkv, G, D))
                continue
            blocks = bt[b, j0:j1].long()
            k = kp[blocks].reshape(-1, Hkv, D).float()
            vv = vp[blocks].reshape(-1, Hkv, D).float()
            pos = torch.arange(j0 * bs, j1 * bs)
            ok = pos < v
            if window:
                ok &= pos >= v - window
            sc = torch.where(ok, torch.einsum("hgd,thd->hgt", qs[b], k),
                             -1e30)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("hgt,thd->hgd", p, vv))
        m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        M = m.amax(0)
        w = torch.where(m == -torch.inf, 0.0, torch.exp(m - M))
        out[b] = ((w[..., None] * acc).sum(0)
                  / (w * l).sum(0).clamp_min(1e-30)[..., None])
    return out.reshape(B, 1, Hq, D), empty


@pytest.mark.parametrize("window", PAGED_WINDOWS)
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_split_k_decomposition_matches_plain_and_reference(jax_ref, shape,
                                                           window):
    jnp, jops, jref = jax_ref
    B, Hkv, G, D, bs, nbps, nblocks, valid = shape
    x = _inputs(B, Hkv * G, Hkv, D, bs, nbps, nblocks, valid,
                seed=G + window)
    got, empty = split_k(*(torch.from_numpy(a) for a in x), window=window)
    assert not torch.isnan(got).any()
    nsplit, bps = PA.split_plan(B, Hkv, nbps, bs)
    if nsplit > 1 and min(valid) <= bps * bs:
        assert empty > 0          # a short row leaves its later splits empty
    plain = _port(*x, "float32", window)
    oracle = np.asarray(jref.ref_paged_attention(
        *_jax_in(jnp, *x, "float32"), window=window), np.float32)
    kernel = np.asarray(jops.paged_attention(
        *_jax_in(jnp, *x, "float32"), window=window), np.float32)
    for want in (plain, oracle, kernel):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES + [PAGED_SERVING, PAGED_LONG],
                         ids=lambda s: f"B{s[0]}-Hkv{s[1]}-bs{s[4]}-nbps{s[5]}")
def test_split_plan_covers_every_block_once(shape):
    B, Hkv, _, _, bs, nbps, _, _ = shape
    nsplit, bps = PA.split_plan(B, Hkv, nbps, bs)
    cols = [c for s in range(nsplit)
            for c in range(s * bps, min((s + 1) * bps, nbps))]
    assert cols == list(range(nbps))            # every block exactly once
    assert (nsplit - 1) * bps < nbps            # no split wholly past nbps
    if shape is PAGED_SERVING:
        assert (nsplit, bps) == (8, 4)
        assert B * Hkv * nsplit >= 264          # two CTAs per SM


def test_wrapper_never_reads_valid_on_the_host():
    """The plan comes from static shapes: the card path reads no device
    tensor on the host (no .item(), .tolist() or .cpu() of valid)."""
    import inspect
    src = inspect.getsource(PA.paged_attention)
    for call in (".item()", ".tolist()", ".cpu()", ".numpy()", "int(valid"):
        assert call not in src


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Needs an sm_90 card; ``python3 chip_smoke.py`` runs the same check
    there, with timings."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper (sm_90) CUDA card; chip_smoke.py "
                    "covers the kernel against its plain version on the card")
    cases = [(s, w) for s in SHAPES for w in PAGED_WINDOWS]
    cases += [(PAGED_SERVING, 0), (PAGED_SERVING, 100), (PAGED_LONG, 0)]
    for i, (shape, window, dtype) in enumerate(
            (s, w, d) for s, w in cases for d in TOL):
        tdt = getattr(torch, dtype)
        B, Hkv, G, D, bs, nbps, nblocks, valid = shape
        x = _inputs(B, Hkv * G, Hkv, D, bs, nbps, nblocks, valid, seed=i)
        args = [_torch(a, tdt).cuda() for a in x[:3]] + \
            [torch.from_numpy(a).cuda() for a in x[3:]]
        before = PA.paged_attention.launches
        out = PA.paged_attention(*args, window=window)
        ref = ref_paged_attention(*args, window=window)
        torch.testing.assert_close(out.float(), ref.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert not torch.isnan(out.float()).any()
        assert PA.paged_attention.launches == before + 1
