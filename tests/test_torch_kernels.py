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
    ATTN_SWEEP, ATTN_TOL, CARD_ONLY_ATTN, RMS_SWEEP, ref_attention,
    ref_rmsnorm)
from repro_torch.kernels.ref import RMS_TOL as TOL_RMS  # noqa: E402
from repro_torch.kernels.rmsnorm import launch_plan  # noqa: E402


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


def _rms_x(a, offset, dtype, device="cpu"):
    """``a`` as a contiguous view starting ``offset`` elements into a
    fresh (16-byte aligned) buffer: offset 1 gives an unaligned x."""
    buf = torch.empty(offset + a.size, dtype=getattr(torch, dtype),
                      device=device)
    buf[offset:] = _t(a.reshape(-1), dtype, device)
    return buf[offset:].view(a.shape)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(1, 2, 1, 128, 128, 80, True, 0),
                                  (1, 2, 2, 64, 128, 80, False, 0)],
                         ids=["causal-gqa", "cross-shape"])
def test_flash_attention_at_d80_matches_reference_kernel(case, dtype,
                                                          jax_ref):
    """A head dim between the instantiated ones (the card runs it in the
    D = 128 kernel, its extra columns masked): the plain version against
    the Pallas kernel in interpret mode, which takes any D."""
    jnp, jops = jax_ref
    arrs = _attn_inputs(case, seed=3)
    got = kops.flash_attention(*(_t(a, dtype) for a in arrs),
                               causal=case[6], window=case[7])
    want = jops.flash_attention(*(jnp.asarray(a).astype(dtype) for a in arrs),
                                causal=case[6], window=case[7],
                                q_block=64, kv_block=64)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])


def test_head_dims_the_kernels_take():
    """Every multiple of 8 up to 256 runs in the next instantiated head
    dim; any other D raises on the card, naming the shape."""
    from repro_torch.kernels.build import head_dim_instance
    assert [head_dim_instance(d, "x") for d in (8, 16, 24, 64, 72, 80, 96,
                                                 128, 136, 256)] == \
        [16, 16, 32, 64, 128, 128, 128, 128, 256, 256]
    for bad in (0, 4, 81, 100, 264, 512):
        with pytest.raises(ValueError, match="q \\(1, 2, 8"):
            head_dim_instance(bad, "q (1, 2, 8, 81)")


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
@pytest.mark.parametrize("shape", RMS_SWEEP)
def test_rmsnorm_matches_reference_kernel(shape, dtype, jax_ref):
    jnp, jops = jax_ref
    shape, offset = shape
    x, g = _rms_inputs(shape)
    kops.rmsnorm.launches = 0
    got = kops.rmsnorm(_rms_x(x, offset, dtype), _t(g, dtype))
    want = jops.rmsnorm(jnp.asarray(x).astype(dtype),
                        jnp.asarray(g).astype(dtype), row_block=16)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL_RMS[dtype],
                               atol=TOL_RMS[dtype])
    assert kops.rmsnorm.launches == 0


@pytest.mark.parametrize("d, el, aligned, plan", [
    # (d, x's element bytes, pointers aligned) -> (vec, threads a row,
    # packs a thread; 0 packs: the generic kernel), one row a CTA
    (4096, 2, True, (8, 64, 8)),            # the co-execution path
    (8192, 2, True, (8, 128, 8)),           # 8 packs a thread at most
    (8192, 4, True, (4, 256, 8)),
    (4096, 4, True, (4, 128, 8)),
    (2048, 4, True, (4, 64, 8)),
    (512, 2, True, (8, 64, 1)),
    (24, 2, True, (8, 32, 1)),              # one warp a row, no barrier
    (8, 2, True, (8, 32, 1)),               # one pack, one live lane
    (1000, 2, True, (8, 64, 2)),            # a row short of its threads
    (100, 2, True, (1, 128, 0)),            # ragged d: generic, scalar
    (16384, 2, True, (8, 256, 0)),          # wide: generic, 16-byte
    (4096, 2, False, (1, 256, 0)),          # unaligned: generic, scalar
])
def test_rmsnorm_launch_plan_picks_the_kernel_by_shape(d, el, aligned, plan):
    assert launch_plan(d, el, aligned) == plan
    vec, threads, packs = plan
    if packs:                               # the row fits its registers
        assert threads * packs * vec >= d > threads * (packs // 2) * vec


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


def test_launch_raises_a_cuda_error_and_counts_only_a_launch(monkeypatch):
    """``build.launch`` calls the entry with each tensor as its data
    pointer and the current stream last; a nonzero return raises, naming
    the kernel and the code, and counts nothing; a zero return counts one
    launch, into the open record too."""
    from types import SimpleNamespace
    from repro_torch.kernels import build
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=77))

    def fake_kernel():
        pass
    fake_kernel.launches = 0
    calls, codes = [], [700, 0]

    def entry(*args):
        calls.append(args)
        return codes[len(calls) - 1]
    x = torch.zeros(4)
    with build.recording_launches() as rec:
        with pytest.raises(RuntimeError, match="^fake_kernel kernel launch "
                                               "failed: CUDA error 700$"):
            build.launch(fake_kernel, entry, x.device, x, None, 3)
        assert fake_kernel.launches == 0 and rec == {}
        build.launch(fake_kernel, entry, x.device, x, None, 3)
    assert fake_kernel.launches == 1 and rec == {fake_kernel: 1}
    assert calls == [(x.data_ptr(), None, 3, 77)] * 2


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
    for shape, offset in RMS_SWEEP:
        xa, ga = _rms_inputs(shape)
        x, g = _rms_x(xa, offset, dtype, card), _t(ga, dtype, card)
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


def _chip_smoke():
    """chip_smoke.py loaded by its path, as a module."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_reads_registers_and_spills_from_the_build_log():
    """chip_smoke.py logs each kernel's registers and spills from nvcc's
    ``-Xptxas -v`` output, with the mangled names shortened."""
    cs = _chip_smoke()
    assert cs.ptxas_entries(PTXAS_LOG) == [
        ("paged_split_kernel<bf16,128,4>", 64, 0),
        ("paged_combine_kernel<bf16>", 32, 40),
        ("flash_f32_kernel<128>", 103, 0),
    ]


RMS_NS = "_ZN43_GLOBAL__N__74c2a8ec_10_rmsnorm_cu_a1f87139"
SSD_NS = "_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_f5ebf9df"
PAGED_NS = "_ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f8"
FLASH_NS = "_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c45a2b18"


def test_chip_smoke_names_the_redesigned_kernels():
    """The rmsnorm, SSD and padded paged kernels' names as chip_smoke.py
    logs them, from the mangled names of nvcc's ``-Xptxas -v`` log of the
    kernels' build (sm_90a): template arguments in any order of types and
    integers, a repeated type as a substitution, and a kernel that is not
    a template."""
    cs = _chip_smoke()
    names = [
        (RMS_NS + "18rmsnorm_reg_kernelI13__nv_bfloat16fLi4EEEvPKT_PKT0_"
         "PS2_if", "rmsnorm_reg_kernel<bf16,f32,4>"),
        (RMS_NS + "18rmsnorm_reg_kernelI13__nv_bfloat16S1_Li8EEEvPKT_PKT0_"
         "PS2_if", "rmsnorm_reg_kernel<bf16,bf16,8>"),
        (RMS_NS + "14rmsnorm_kernelIffLi4EEEvPKT_PKT0_PS1_if",
         "rmsnorm_kernel<f32,f32,4>"),
        (SSD_NS + "14ssd_state_bf16I13__nv_bfloat16EEvNS_4ArgsE",
         "ssd_state_bf16<bf16>"),
        (SSD_NS + "12ssd_out_bf16IfEEvNS_4ArgsE", "ssd_out_bf16<f32>"),
        (SSD_NS + "13ssd_state_f32I13__nv_bfloat16EEvNS_4ArgsE",
         "ssd_state_f32<bf16>"),
        (SSD_NS + "15ssd_pass_kernelENS_4ArgsEi", "ssd_pass_kernel"),
        (PAGED_NS + "25paged_split_padded_kernelIfLi256ELi16EEEvPKT_S3_S3_"
         "PKiS5_PS1_Pfiiiiiif", "paged_split_padded_kernel<f32,256,16>"),
        # bool arguments: the masked head-dim instantiations
        (PAGED_NS + "20paged_combine_kernelI13__nv_bfloat16Lb1EEEvPKfPT_"
         "iiiiii", "paged_combine_kernel<bf16,true>"),
        (FLASH_NS + "17flash_bf16_kernelILi64ELb0EEEvPK13__nv_bfloat16S3_"
         "S3_PS1_iiiiiiiif", "flash_bf16_kernel<64,false>"),
    ]
    for mangled, want in names:
        assert cs._short_kernel(mangled) == want


def test_chip_smoke_holds_kernels_to_the_benchmarks_peaks_and_bound():
    """chip_smoke.py's peaks are portbench's, and its paged bound is the
    one the ledger's ``kernel.paged_attention_roofline`` divides by."""
    cs = _chip_smoke()
    from portbench.roofline import bounds, peaks
    assert cs.HBM_BYTES_PER_S == peaks.HBM_BYTES_PER_S
    assert cs.OPS_PER_S is peaks.OPS_PER_S
    for dtype, el, window in ((torch.bfloat16, 2, 0),
                              (torch.float32, 4, 64)):
        q = torch.zeros(2, 1, 16, 128, dtype=dtype)
        kp = torch.zeros(20, 16, 4, 128, dtype=dtype)
        valid = torch.tensor([100, 20], dtype=torch.int32)
        assert cs.paged_bound_ms(q, kp, valid, 16, window) == \
            bounds.paged_bound_ms([100, 20], 16, 4, 128, 16, el=el,
                                  window=window, dtype=str(dtype)[6:])
