"""The port's rmsnorm and flash-attention kernel entry points against the
JAX reference's Pallas kernels.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run their
plain versions, because a CPU tensor means the caller asked for the CPU;
they are held against the reference's Pallas kernels in interpret mode
(``repro.kernels.ops``), as the reference's own ``tests/test_kernels.py``
runs them, over its shape sweeps and at its tolerances, on the same
numpy-seeded inputs.  The CUDA kernels run only on the card:
``chip_smoke.py`` holds them against their plain versions there, and the
tests below that need the card (marker ``cuda``) skip elsewhere.  The
reference is imported by a fixture, so this file also collects on the
card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ref import ref_attention, ref_rmsnorm  # noqa: E402

# tests/test_kernels.py:17-25, plus the causal Sq != Skv case the
# reference's test skips (positions count from 0 on both axes) and a
# window whose last rows reach no key (the plain version's uniform row)
ATTN_SWEEP = [
    # (B, H, Hkv, Sq, Skv, D, causal, window)
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 8, 2, 256, 256, 64, True, 0),          # GQA
    (1, 4, 1, 128, 128, 128, True, 0),         # MQA
    (2, 4, 4, 128, 128, 64, False, 0),         # bidirectional
    (1, 4, 2, 256, 256, 64, True, 64),         # sliding window
    (1, 2, 2, 64, 256, 64, False, 0),          # cross-shape (Sq != Skv)
    (1, 2, 2, 64, 256, 64, True, 0),           # causal, Sq != Skv
]
CARD_ONLY_ATTN = [
    (2, 2, 1, 100, 37, 32, False, 16),         # ragged; rows past every key
    (1, 2, 2, 77, 77, 16, True, 0),            # ragged causal
]
RMS_SHAPES = [(4, 128), (2, 16, 256), (64, 512)]   # tests/test_kernels.py:77
TOL_ATTN = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_RMS = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jax_ref():
    """(jax.numpy, repro.kernels.ops), with JAX on the CPU as the
    reference's own tests run it (interpret-mode Pallas)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the reference comparisons run with JAX on the CPU")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jnp, jops


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper (sm_90) CUDA card; chip_smoke.py holds "
                    "the kernels against their plain versions on the card")
    return torch.device("cuda")


def _attn_inputs(case, seed=0):
    B, H, Hkv, Sq, Skv, D, _, _ = case
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, Hkv, Skv, D).astype(np.float32),
            rng.randn(B, Hkv, Skv, D).astype(np.float32))


def _rms_inputs(shape, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            (rng.randn(shape[-1]) * 0.1).astype(np.float32))


def _t(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_SWEEP)
def test_flash_attention_matches_reference_kernel(case, dtype, jax_ref):
    jnp, jops = jax_ref
    causal, window = case[6], case[7]
    arrs = _attn_inputs(case)
    kops.flash_attention.launches = 0
    got = kops.flash_attention(*(_t(a, dtype) for a in arrs),
                               causal=causal, window=window)
    want = jops.flash_attention(*(jnp.asarray(a).astype(dtype) for a in arrs),
                                causal=causal, window=window,
                                q_block=64, kv_block=64)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL_ATTN[dtype],
                               atol=TOL_ATTN[dtype])
    assert kops.flash_attention.launches == 0       # the CPU launches nothing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_matches_reference_kernel(shape, dtype, jax_ref):
    jnp, jops = jax_ref
    x, g = _rms_inputs(shape)
    kops.rmsnorm.launches = 0
    got = kops.rmsnorm(_t(x, dtype), _t(g, dtype))
    want = jops.rmsnorm(jnp.asarray(x).astype(dtype),
                        jnp.asarray(g).astype(dtype), row_block=16)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL_RMS[dtype],
                               atol=TOL_RMS[dtype])
    assert kops.rmsnorm.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v = (_t(a, "float32") for a in _attn_inputs(ATTN_SWEEP[1]))
    with pytest.raises(ValueError):
        kops.flash_attention(q[:, :7], k, v)              # H % Hkv != 0
    with pytest.raises(ValueError):
        kops.flash_attention(q, k[..., :32], v[..., :32])   # head dim
    with pytest.raises(ValueError):
        kops.flash_attention(q[0], k[0], v[0])              # not 4-d
    with pytest.raises(ValueError):
        kops.flash_attention(q, k, v, window=-1)
    x, g = (_t(a, "float32") for a in _rms_inputs((4, 128)))
    with pytest.raises(ValueError):
        kops.rmsnorm(x, g[:64])
    with pytest.raises(NotImplementedError):
        kops.rmsnorm(x.to("meta"), g.to("meta"))
    with pytest.raises(NotImplementedError):
        kops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain_version(dtype, card):
    for case in ATTN_SWEEP + CARD_ONLY_ATTN:
        q, k, v = (_t(a, dtype, card) for a in _attn_inputs(case))
        before = kops.flash_attention.launches
        out = kops.flash_attention(q, k, v, causal=case[6], window=case[7])
        ref = ref_attention(q, k, v, causal=case[6], window=case[7])
        torch.testing.assert_close(out.float(), ref.float(),
                                   rtol=TOL_ATTN[dtype], atol=TOL_ATTN[dtype])
        assert kops.flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_matches_plain_version(dtype, card):
    for shape in RMS_SHAPES + [(3, 100), (2, 16384), (4096, 4096)]:
        x, g = (_t(a, dtype, card) for a in _rms_inputs(shape))
        before = kops.rmsnorm.launches
        out = kops.rmsnorm(x, g)
        torch.testing.assert_close(out.float(), ref_rmsnorm(x, g).float(),
                                   rtol=TOL_RMS[dtype], atol=TOL_RMS[dtype])
        assert kops.rmsnorm.launches == before + 1
