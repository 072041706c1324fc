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

import importlib.util
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    ATTN_SWEEP, ATTN_TOL, CARD_ONLY_ATTN, ref_attention, ref_rmsnorm)

RMS_SHAPES = [(4, 128), (2, 16, 256), (64, 512)]   # tests/test_kernels.py:77
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
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])
    assert kops.flash_attention.launches == 0       # the CPU launches nothing


def flash_bf16p(q, k, v, *, causal=True, window=0, tile=64):
    """The bf16 kernel's arithmetic in plain torch: 64-key tiles, scores
    scaled by D^-0.5 * log2(e) in f32 and then masked, an online softmax
    in base 2, P rounded to bf16 before P.V (the row sum over the
    unrounded P), the output acc / max(l, 1e-30) in q's dtype."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, H // Hkv, Sq, D)
    qpos = torch.arange(Sq)[:, None]
    m = torch.full(qf.shape[:-1], -1e30)
    l = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, Skv, tile):
        kt, vt = k[:, :, k0:k0 + tile].float(), v[:, :, k0:k0 + tile].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * (
            D ** -0.5 * math.log2(math.e))
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Sq, D).to(q.dtype)


@pytest.mark.parametrize("case", ATTN_SWEEP)
def test_bf16_p_emulation_matches_reference_kernel(case, jax_ref):
    """Rounding P to bf16 before P.V (the tensor-core kernel's numerics)
    stays within the reference tests' bf16 contract (2e-2) of the Pallas
    kernel, which rounds nothing."""
    jnp, jops = jax_ref
    causal, window = case[6], case[7]
    arrs = _attn_inputs(case)
    got = flash_bf16p(*(_t(a, "bfloat16") for a in arrs), causal=causal,
                      window=window)
    want = jops.flash_attention(*(jnp.asarray(a).astype("bfloat16")
                                  for a in arrs), causal=causal,
                                window=window, q_block=64, kv_block=64)
    assert not torch.isnan(got.float()).any()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=ATTN_TOL["bfloat16"],
                               atol=ATTN_TOL["bfloat16"])


def test_bf16_p_emulation_covers_rows_past_every_key():
    """The card-only ragged cases (no Pallas run here): the emulation
    against the plain version, in f32 inputs so that only P's rounding
    differs."""
    for case in CARD_ONLY_ATTN:
        q, k, v = (_t(a, "float32") for a in _attn_inputs(case))
        q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
        got = flash_bf16p(q, k, v, causal=case[6], window=case[7])
        want = ref_attention(q, k, v, causal=case[6], window=case[7])
        torch.testing.assert_close(got, want, rtol=ATTN_TOL["bfloat16"],
                                   atol=ATTN_TOL["bfloat16"])


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
                                   rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
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


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f818paged_split_kernelI13__nv_bfloat16Li128ELi4EEEvPKT_S4_S4_PKiS6_PS2_Pfiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f818paged_split_kernelI13__nv_bfloat16Li128ELi4EEEvPKT_S4_S4_PKiS6_PS2_Pfiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f820paged_combine_kernelI13__nv_bfloat16EEvPKfPT_iiiii' for 'sm_90a'
    24 bytes stack frame, 40 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c45a2b1816flash_f32_kernelILi128EEEvPKfS2_S2_Pfiiiiiif' for 'sm_90a'
ptxas info    : Used 103 registers, used 1 barriers
"""


def test_chip_smoke_reads_registers_and_spills_from_the_build_log():
    """chip_smoke.py logs each kernel's registers and spills from nvcc's
    ``-Xptxas -v`` output, with the mangled names shortened."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.ptxas_entries(PTXAS_LOG) == [
        ("paged_split_kernel<bf16,128,4>", 64, 0),
        ("paged_combine_kernel<bf16>", 32, 40),
        ("flash_f32_kernel<128>", 103, 0),
    ]
