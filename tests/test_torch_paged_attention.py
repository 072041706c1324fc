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
from repro_torch.kernels.ref import ref_paged_attention  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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


# (B, Hkv, G, D, bs, nbps, nblocks, valid): the tests/test_paged.py shape
# with G in {1, 4}, plus a wider one with ragged rows and trash tails
SHAPES = [
    (3, 2, 1, 16, 8, 4, 9, [5, 9, 16]),
    (3, 2, 4, 16, 8, 4, 9, [5, 9, 16]),
    (4, 2, 8, 64, 16, 4, 12, [1, 16, 17, 40]),
]


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


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"G{s[2]}-D{s[3]}")
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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Needs an sm_90 card; ``python3 chip_smoke.py`` runs the same check
    (and more shapes) there."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper (sm_90) CUDA card; chip_smoke.py "
                    "covers the kernel against its plain version on the card")
    for dtype in ("float32", "bfloat16"):
        q, kp, vp, bt, vl = _inputs(8, 32, 8, 128, 16, 32, 257,
                                    [1, 17, 100, 255, 256, 300, 444, 512], 3)
        tdt = getattr(torch, dtype)
        args = [_torch(q, tdt).cuda(), _torch(kp, tdt).cuda(),
                _torch(vp, tdt).cuda(), torch.from_numpy(bt).cuda(),
                torch.from_numpy(vl).cuda()]
        out = PA.paged_attention(*args)
        ref = ref_paged_attention(*args)
        torch.testing.assert_close(out.float(), ref.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
