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

:func:`ssd_scan_bwd` is the scan's gradient, launched by the model's
``SSDScan.backward`` once a layer.  It replaces no TPU kernel: the
reference differentiates its chunked math with XLA.  One call runs the
forward's chunk and state passes again (the f32 states entering each
chunk; the forward saves nothing but its inputs), the gradient's chunk
pass (the same kernels on dy and C), a reverse state pass, the gradient
pass and a last pass that sums the per-CTA partials of dA, dB and dC in
a fixed order, and counts as one launch in ``ssd_scan_bwd.launches``.
The gradient pass runs one CTA of 8 warps per (b, chunk, group of heads)
and, for bf16, every product on the tensor cores (``mma.sync``
m16n8k16 from ``ldmatrix`` fragments; h_c, D_c, M and T as bf16 hi + lo,
the rounding points of ``ref.ref_ssd_bwd(..., round_bf16=True)``), the
next head's tiles in flight by ``cp.async`` while one computes, and dB
and dC summed over the CTA's heads in registers, written once; it takes
one CTA a SM (:func:`grad_occupancy` reads what it asks of the card).
For f32 it runs exact f32 FMAs.  What bounds the call is its f32 state
scratch (:func:`bwd_scratch`, one ``torch.empty``), which the other
passes write and read several times.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import call, entry, launch
from repro_torch.kernels.ref import ref_ssd, ref_ssd_bwd

NAME = "ssd_scan"
P_TILE = 16                         # P must be a multiple of this
MAX_STATE = 256                     # largest N the shared-memory plan takes
MAX_STATE_BWD = 128                 # largest N the backward's plan takes
CHUNK = 64                          # tokens a chunk (csrc kQ)
_TARGET_CTAS = 264                  # CTAs the head groups aim for (2 a SM)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entries' arguments (strides as 64-bit ints)
_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
         + [ctypes.c_longlong] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 13 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def grad_occupancy(N: int, P: int, dtype) -> dict:
    """What the backward's gradient pass asks of the current CUDA device
    at N and P for x of ``dtype``: dynamic shared memory a CTA, CTAs a SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local (spilled) bytes a thread, threads a CTA.  Builds the kernels;
    needs a CUDA device."""
    out = (ctypes.c_int * 5)()
    call("ssd_grad occupancy query",
         entry(NAME, "repro_ssd_grad_occupancy",
               [ctypes.c_int] * 3 + [ctypes.c_void_p]),
         N, P, _DTYPES[dtype], ctypes.addressof(out))
    return dict(zip(("smem_bytes", "ctas_per_sm", "registers", "threads",
                     "local_bytes"), out))


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


def bwd_scratch(B, S, H, P, N):
    """[(name, bytes)] of the backward's f32 scratch, in its order in the
    one allocation (each part 256-byte aligned): the recomputed chunk
    states and decays (none for one chunk), g then D per chunk and the
    decays of (a'), the per-CTA partials of dB and dC (one [64, N] per
    (b, chunk, head group)) and of dA."""
    nc, hg = plan(B, S, H)
    groups = -(-H // hg)
    pn, per = 4 * B * nc * H * P * N, 4 * B * nc * H
    part = 4 * B * nc * groups * CHUNK * N
    return [("states", pn if nc > 1 else 0), ("decay", per if nc > 1 else 0),
            ("gs", pn), ("gdecay", per), ("dBp", part), ("dCp", part),
            ("dAp", per)]


def _align(n: int) -> int:
    return -(-n // 256) * 256


def bwd_scratch_bytes(B, S, H, P, N) -> int:
    return sum(_align(n) for _, n in bwd_scratch(B, S, H, P, N))


def _vec_ok(x, Bm, Cm, N, *more) -> bool:
    """x, Bm and Cm (and ``more``, x's shape) take 16-byte loads: aligned
    pointers, and strides (of axes longer than 1) and N in 16-byte
    units."""
    el = x.element_size()
    if N * el % 16:
        return False
    for t in (x, Bm, Cm) + more:
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


def _check_types(x, dt, A, Bm, Cm, what):
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype \
            or dt.dtype not in _DTYPES or A.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 or bfloat16 x/Bm/Cm of one "
                        f"dtype, float32 or bfloat16 dt and float32 A; got "
                        f"{x.dtype}/{Bm.dtype}/{Cm.dtype}, {dt.dtype}, "
                        f"{A.dtype}")


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
    _check_types(x, dt, A, Bm, Cm, "ssd_scan")
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
    launch(ssd_scan, entry(NAME, "repro_ssd_scan", _ARGS), dev,
           x, dt, A, Bm, Cm, y, h_final, states, decay, hsplit,
           B, S, H, P, N, x.stride(0), x.stride(1), x.stride(2),
           dt.stride(0), dt.stride(1), dt.stride(2),
           Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
           _DTYPES[x.dtype], _DTYPES[dt.dtype], hg,
           int(_vec_ok(x, Bm, Cm, N)))
    return (y, h_final) if return_final else y


ssd_scan.launches = 0


def ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dh_final=None):
    """The gradients of :func:`ssd_scan` (shapes as there) for the
    cotangents ``dy`` [B,S,H,P] of y and ``dh_final`` [B,H,P,N] of the
    final state (None: y only) -> (dx, ddt, dA, dB, dC) in x's, dt's, A's
    (f32), Bm's and Cm's dtypes.  A CUDA tensor launches the backward
    kernels of ``csrc/ssd_scan.cu`` (the forward's chunk and state passes
    recomputed, then the gradient's chunk, reverse state and gradient
    passes and the last sums; one launch in ``ssd_scan_bwd.launches``) or
    raises; a CPU tensor runs ``ref.ref_ssd_bwd``, the same decomposition
    in plain torch (for bf16 the kernels round as ``ref_ssd_bwd(...,
    round_bf16=True)`` does).  Sums across CTAs (dA over tokens, dB and dC
    over head groups) go through scratch in a fixed order, with no
    atomics: two calls give equal bits."""
    B, S, H, P, N = _check(x, dt, A, Bm, Cm)
    if tuple(dy.shape) != tuple(x.shape) or (
            dh_final is not None and tuple(dh_final.shape) != (B, H, P, N)):
        got = None if dh_final is None else tuple(dh_final.shape)
        raise ValueError(f"ssd_scan_bwd takes dy shaped as x "
                         f"{tuple(x.shape)} and dh_final [B,H,P,N]; got "
                         f"{tuple(dy.shape)}, {got}")
    ts = (x, dt, A, Bm, Cm, dy) + (() if dh_final is None else (dh_final,))
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"ssd_scan_bwd inputs span devices {devs}")
    if x.device.type == "cpu":
        return ref_ssd_bwd(x, dt, A, Bm, Cm, dy, dh_final, chunk=CHUNK)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no ssd_scan_bwd kernel for {x.device}")
    _check_types(x, dt, A, Bm, Cm, "ssd_scan_bwd")
    if dy.dtype != x.dtype or (dh_final is not None
                               and not dh_final.is_floating_point()):
        raise TypeError(f"ssd_scan_bwd takes dy in x's dtype {x.dtype} and a "
                        f"floating dh_final; got {dy.dtype}, "
                        f"{None if dh_final is None else dh_final.dtype}")
    if P % P_TILE or N % 4 or not 0 < N <= MAX_STATE_BWD:
        raise ValueError(f"ssd_scan_bwd kernel takes P a multiple of "
                         f"{P_TILE} and N a multiple of 4 up to "
                         f"{MAX_STATE_BWD}; got P={P}, N={N}")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B}, H={H} exceed the kernel's grid")
    dev = x.device
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    dC = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    if B * S * H * P == 0:
        for t in (dx, ddt, dA, dB, dC):
            t.zero_()
        return dx, ddt.to(dt.dtype), dA, dB, dC
    nc, hg = plan(B, S, H)
    x, Bm, Cm, dy = (_last_contiguous(t) for t in (x, Bm, Cm, dy))
    A, dt_dtype = A.contiguous(), dt.dtype
    dt = dt.float()             # the kernels take f32 dt (exact from bf16)
    dh = None
    if dh_final is not None:
        dh = dh_final.float().contiguous()
        if dh.data_ptr() % 16:
            dh = dh.clone()
    parts = bwd_scratch(B, S, H, P, N)
    scratch = torch.empty(sum(_align(n) for _, n in parts),
                          dtype=torch.uint8, device=dev)
    ptrs, at = [], scratch.data_ptr()       # in the entry's order
    for _, n in parts:
        ptrs.append(at if n else None)
        at += _align(n)
    launch(ssd_scan_bwd, entry(NAME, "repro_ssd_scan_bwd", _BWD_ARGS), dev,
           x, dt, A, Bm, Cm, dy, dh, dx, ddt, dA, dB, dC, *ptrs,
           B, S, H, P, N, x.stride(0), x.stride(1), x.stride(2),
           dt.stride(0), dt.stride(1), dt.stride(2),
           Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
           dy.stride(0), dy.stride(1), dy.stride(2),
           _DTYPES[x.dtype], hg, int(_vec_ok(x, Bm, Cm, N, dy)))
    return dx, ddt.to(dt_dtype), dA, dB, dC


ssd_scan_bwd.launches = 0
