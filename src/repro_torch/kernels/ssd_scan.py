"""Mamba-2 SSD chunked scan: the wrapper of the Hopper kernels.

Per (batch, head): ``y = (C·Bᵀ ∘ L)·(dt·x) + exp(cumsum)·C·hᵀ`` chunk by
chunk, with the f32 state ``h [P, N]`` carried across chunks.  The kernels
(``csrc/ssd_scan.cu``, CUDA C++ for ``sm_90a``) replace the TPU kernel
``src/repro/kernels/ssd_scan.py:_ssd_kernel`` with Mamba-2's own GPU
decomposition, the chunks in parallel CTAs: one call launches up to three
kernels — (a) the chunk pass (each chunk's state and total decay, one CTA
per (b, chunk, group of heads)), (b) the state pass (the f32 states
carried across chunks, sequential over chunks, parallel over (b, h, P·N))
and (c) the output pass (C·Bᵀ formed once per (b, chunk, group of heads),
then ``y`` per head) — and counts as ONE launch in
``ssd_scan.launches`` (one per model layer).  bf16 runs its products on
the tensor cores (``mma.sync`` m16n8k16, f32 accumulation; the rounding
points are ``ref.ssd_chunk_parallel(..., round_bf16=True)``'s), f32 on
exact f32 FMAs.  A ragged last chunk is zero-filled, so every length runs
at the kernels' own chunk of :data:`CHUNK` tokens.
``return_final`` also returns the state after the last token, ``h_final
[B, H, P, N]`` f32: the state the TPU kernel holds in VMEM scratch after
its last chunk.  The wrapper allocates the kernels' scratch (the f32
chunk states ``[B, nc, H, P, N]`` and decays ``[B, nc, H]``, and for
bf16 the carried states as bf16 hi + lo ``[B, nc, H, 2, P, N]``;
:func:`scratch_bytes`) with ``torch.empty`` on the inputs' device.

The wrapper checks device, dtypes and shapes and raises on anything the
kernels do not take.  A CUDA tensor launches the kernels (or raises); a
CPU tensor runs the plain version (``ref.ref_ssd``, the sequential
recurrence), because a CPU tensor means the caller asked for the CPU.
There is no fallback from the one to the other, and no host read of a
device tensor.  The kernels read their inputs through their strides (the
model hands them slices of the conv output, rows 1792 elements apart);
only a last axis that is not contiguous is copied.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import count_launch
from repro_torch.kernels.ref import ref_ssd

NAME = "ssd_scan"
P_TILE = 16                         # P must be a multiple of this
MAX_STATE = 256                     # largest N the shared-memory plan takes
CHUNK = 64                          # tokens a chunk (csrc kQ)
_TARGET_CTAS = 264                  # CTAs the head groups aim for (2 a SM)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    from repro_torch.kernels.build import library
    fn = library(NAME).repro_ssd_scan
    if fn.argtypes is None:
        # pointers and the stream as c_void_p (a bare int would be cut),
        # strides as 64-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def plan(B: int, S: int, H: int):
    """(nc, heads per CTA) of a call: the number of chunks, and the heads
    one CTA of the chunk and output passes takes (as many as keep
    ``_TARGET_CTAS`` CTAs, since C·Bᵀ is formed once per CTA)."""
    nc = -(-S // CHUNK)
    per = max(1, (B * nc * H) // _TARGET_CTAS)
    groups = -(-H // per)
    return nc, -(-H // groups)


def scratch_bytes(B, S, H, P, N, final, dtype) -> int:
    """Bytes of scratch one call allocates (in one ``torch.empty``): the
    f32 chunk states and decays and, for bf16, the carried states as bf16
    hi + lo."""
    nc, _ = plan(B, S, H)
    if nc == 1 and not final:
        return 0
    split = 4 * B * nc * H * P * N if dtype == torch.bfloat16 and nc > 1 \
        else 0
    return 4 * B * nc * H * (P * N + 1) + split


def _vec_ok(x, Bm, Cm, N) -> bool:
    """x, Bm and Cm take 16-byte loads: aligned pointers, and strides (of
    axes longer than 1) and N in 16-byte units."""
    el = x.element_size()
    if N * el % 16:
        return False
    for t in (x, Bm, Cm):
        if t.data_ptr() % 16:
            return False
        if any(st * el % 16 for st, n in zip(t.stride()[:-1], t.shape[:-1])
               if n > 1):
            return False
    return True


def _check(x, dt, A, Bm, Cm):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan takes x [B,S,H,P], dt [B,S,H], A [H], "
                         f"Bm/Cm [B,S,N]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    if tuple(dt.shape) != (B, S, H) or A.shape[0] != H \
            or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"ssd_scan shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    return B, S, H, P, Bm.shape[-1]


def _last_contiguous(t):
    return t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128,
             return_final: bool = False):
    """x: [B,S,H,P]; dt: [B,S,H]; A: [H] f32; Bm/Cm: [B,S,N] -> y
    [B,S,H,P] in x's dtype (and h_final [B,H,P,N] f32 when
    ``return_final``).  ``chunk`` is kept only for the reference's
    signature: neither the kernels (:data:`CHUNK`) nor ``ref_ssd``
    depends on it."""
    B, S, H, P, N = _check(x, dt, A, Bm, Cm)
    devs = {t.device for t in (x, dt, A, Bm, Cm)}
    if len(devs) != 1:
        raise ValueError(f"ssd_scan inputs span devices {devs}")
    if x.device.type == "cpu":
        return ref_ssd(x, dt, A, Bm, Cm, return_final=return_final)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no ssd_scan kernel for {x.device}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype \
            or dt.dtype not in _DTYPES or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x/Bm/Cm of one "
                        f"dtype, float32 or bfloat16 dt and float32 A; got "
                        f"{x.dtype}/{Bm.dtype}/{Cm.dtype}, {dt.dtype}, "
                        f"{A.dtype}")
    if P % P_TILE or N % 4 or not 0 < N <= MAX_STATE:
        raise ValueError(f"ssd_scan kernel takes P a multiple of {P_TILE} "
                         f"and N a multiple of 4 up to {MAX_STATE}; got "
                         f"P={P}, N={N}")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B}, H={H} exceed the kernel's grid")
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    h_final = (torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
               if return_final else None)
    if B * S * H * P == 0:
        if return_final:
            h_final.zero_()
        return (y, h_final) if return_final else y
    nc, hg = plan(B, S, H)
    # one allocation for the scratch: f32 chunk states, then (bf16) the
    # carried states as hi + lo, then the f32 decays
    states = decay = hsplit = None
    nbytes = scratch_bytes(B, S, H, P, N, return_final, x.dtype)
    if nbytes:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        states = scratch.data_ptr()
        end = states + 4 * B * nc * H * P * N
        if nc > 1 and x.dtype == torch.bfloat16:
            hsplit, end = end, end + 4 * B * nc * H * P * N
        decay = end
    x, Bm, Cm = (_last_contiguous(t) for t in (x, Bm, Cm))
    A = A.contiguous()
    err = _entry()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                   Cm.data_ptr(), y.data_ptr(),
                   h_final.data_ptr() if return_final else None,
                   states, decay, hsplit,
                   B, S, H, P, N,
                   x.stride(0), x.stride(1), x.stride(2),
                   dt.stride(0), dt.stride(1), dt.stride(2),
                   Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                   _DTYPES[x.dtype], _DTYPES[dt.dtype], hg,
                   int(_vec_ok(x, Bm, Cm, N)),
                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    count_launch(ssd_scan)
    return (y, h_final) if return_final else y


ssd_scan.launches = 0
