"""Paged-attention decode: the wrapper of the Hopper kernel (DESIGN.md §12).

Single-token decode over a paged KV cache: K/V live in a flat arena of
``[num_blocks, bs, Hkv, D]`` fixed-size blocks and each batch row owns a
block table ``bt[b, j] -> arena block id``.  The kernel
(``csrc/paged_attention.cu``, CUDA C++ for ``sm_90a``) replaces the TPU
kernel ``src/repro/kernels/paged_attention.py:_paged_kernel`` with a
split-K (flash-decoding) design: :func:`split_plan` cuts each row's
blocks into splits from the static shapes alone, one CTA per (split, KV
head, row) reads the row's table itself, copies only the blocks that hold
valid positions into shared memory and runs an f32 softmax over them, and
a second kernel merges each row's partials.  Rows shorter than ``nbps``
blocks point their tail table entries at the trash block 0; those
positions are masked and never read.  Any group G = Hq/Hkv up to 16
and any head dim D <= 256 that is a multiple of 8 run: G in ``GROUPS``
at D in ``build.HEAD_DIMS`` in their own instantiation (G and D
compile-time constants there), any other pair in a padded instantiation
of the next size in ``PADDED_GROUPS`` and ``build.HEAD_DIMS``
(:func:`padded_group`), its extra query rows computing on zeros and never
written, its extra columns zero-filled in the copies into shared memory
and never stored: the arena is never padded or copied.

The wrapper checks device, dtype, shapes and contiguity and raises on
anything the kernel does not take.  It never reads a device tensor on the
host (``valid`` changes every decode step; a read would sync each layer).
A CUDA tensor launches the kernels (or raises); a CPU tensor runs the
plain version (``ref.ref_paged_attention``), because a CPU tensor means
the caller asked for the CPU.  There is no fallback from the one to the
other.  ``paged_attention.launches`` counts wrapper calls that reached
the card, one per layer per decode step: one call launches the split
kernel and, when a row has more than one split, the combine kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import entry, head_dim_instance, launch
from repro_torch.kernels.ref import ref_paged_attention

NAME = "paged_attention"
GROUPS = (1, 2, 4, 5, 6, 8, 10)      # csrc exact_group instantiations
PADDED_GROUPS = (4, 8, 16)           # csrc instantiations for other G
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448                 # an H100 CTA's shared memory (227 KB)
SPLIT_TOKENS = 64                   # cache positions a split aims to cover
MIN_CTAS = 2 * 132                  # two CTAs for each of the H100's SMs
_WARPS = 4                          # csrc kWarps
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def padded_group(G: int, exact_dim: bool = True) -> int:
    """The instantiated group that runs G query heads a KV head (csrc
    padded_group): G where it is in ``GROUPS``, else (or at a head dim
    between the instantiated ones, ``exact_dim`` False: csrc padded_rows)
    the next larger of ``PADDED_GROUPS``, whose extra query rows compute
    on zeros and are never written."""
    if G in GROUPS and exact_dim:
        return G
    for gp in PADDED_GROUPS:
        if 0 < G <= gp:
            return gp
    raise ValueError(f"paged_attention kernel takes Hq/Hkv from 1 to "
                     f"{PADDED_GROUPS[-1]}, got {G}")


def split_plan(B: int, Hkv: int, nbps: int, bs: int):
    """(splits per row, blocks per split) from the static shapes alone.

    A split covers ``SPLIT_TOKENS`` positions (one block when a block is
    larger); it halves while the grid of ``B * Hkv * splits`` CTAs is
    smaller than ``MIN_CTAS``.  Split s covers table columns
    ``[s * bps, min((s + 1) * bps, nbps))``."""
    bps = max(1, min(nbps, SPLIT_TOKENS // bs))
    while bps > 1 and B * Hkv * -(-nbps // bps) < MIN_CTAS:
        bps //= 2
    return -(-nbps // bps), bps


def split_smem_bytes(D: int, G: int, bs: int, bps: int, itemsize: int):
    """Shared memory of one split CTA (csrc split_smem_bytes): K and V of
    the split, its scores, the cross-warp sums and its table entries."""
    tok = bps * bs
    return 2 * tok * D * itemsize + 4 * (G * tok + _WARPS * G * D) + 4 * bps


def _check(q, kp, vp, bt, valid, window):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, Hq, D], got {tuple(q.shape)}")
    if kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError("kp/vp must both be [num_blocks, bs, Hkv, D]")
    B, _, Hq, D = q.shape
    if kp.shape[3] != D:
        raise ValueError(f"head dim mismatch: q {D}, kv {kp.shape[3]}")
    Hkv = kp.shape[2]
    if Hq % Hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0 ({Hq}, {Hkv})")
    if bt.dim() != 2 or bt.shape[0] != B or valid.shape != (B,):
        raise ValueError("bt must be [B, nbps] and valid [B]")
    if window < 0:
        raise ValueError("window must be >= 0")
    return B, Hq, Hkv, D, kp.shape[1], bt.shape[1]


def paged_attention(q, kp, vp, bt, valid, *, window: int = 0):
    """q: [B,1,Hq,D]; kp/vp: [num_blocks,bs,Hkv,D]; bt: [B,nbps] int;
    valid: [B] int valid lengths.  Returns [B,1,Hq,D] in q's dtype."""
    B, Hq, Hkv, D, bs, nbps = _check(q, kp, vp, bt, valid, window)
    devs = {t.device for t in (q, kp, vp, bt, valid)}
    if len(devs) != 1:
        raise ValueError(f"paged_attention inputs span devices {devs}")
    if q.device.type == "cpu":
        return ref_paged_attention(q, kp, vp, bt, valid, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention kernel for {q.device}")
    if q.dtype not in _DTYPES or kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q/kp/vp "
                        f"of one dtype, got {q.dtype}/{kp.dtype}/{vp.dtype}")
    G = Hq // Hkv
    DI = head_dim_instance(D, f"paged_attention q {tuple(q.shape)}, "
                              f"arena {tuple(kp.shape)}")
    gp = padded_group(G, DI == D)
    nsplit, bps = split_plan(B, Hkv, nbps, bs)
    smem = split_smem_bytes(DI, gp, bs, bps, q.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"block size {bs} needs {smem} bytes of shared "
                         f"memory per CTA, more than the kernel's "
                         f"{SMEM_LIMIT}")
    if not (q.is_contiguous() and kp.is_contiguous()
            and vp.is_contiguous()):
        raise ValueError("paged_attention needs contiguous q, kp and vp")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("paged_attention reads kp/vp as 16-byte vectors: "
                         "they must be 16-byte aligned")
    bt = bt.to(torch.int32).contiguous()
    valid = valid.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    # the split partials: (m, l) per query head, then the f32 accumulators
    # (rows of the instantiated head dim)
    part = (torch.empty(B * Hkv * nsplit * G * (2 + DI), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    launch(paged_attention, entry(NAME, "repro_paged_attention", _ARGS),
           q.device, q, kp, vp, bt, valid, out, part, B, Hkv, G, D, bs,
           nbps, bps, nsplit, int(window), _DTYPES[q.dtype])
    return out


paged_attention.launches = 0
