"""Forward flash attention: the wrapper of the Hopper kernel.

Causal / sliding-window / GQA online-softmax attention over q
``[B, H, Sq, D]`` and k/v ``[B, Hkv, Skv, D]`` (Sq != Skv allowed, positions
from 0 on both axes).  The kernel (``csrc/flash_attention.cu``, CUDA C++
for ``sm_90a``) replaces the TPU kernel
``src/repro/kernels/flash_attention.py:_attn_kernel``: one CTA per (b, h,
64-query tile) streams K/V tiles through shared memory with an f32 online
softmax and skips tiles no row of it can attend to.  bfloat16 runs on the
tensor cores (``wgmma`` on 64-key tiles that ``cp.async`` copies into
shared memory) and rounds P to bf16 before P·V, so it matches the plain
version within the bf16 tolerance (2e-2), not bit for bit; float32 stays
exact f32 on the CUDA cores.  Ragged tails are masked in the kernel, so
every length the reference accepts works, and so is any head dim D <= 256
that is a multiple of 8: it runs in the instantiation of the next size in
``build.HEAD_DIMS``, the columns past D zero-filled in the loads and
never stored, with the scale D^-0.5 of the true D.

The wrapper checks device, dtypes and shapes and raises on anything the
kernel does not take.  A CUDA tensor launches the kernel (or raises); a
CPU tensor runs the plain version (``ref.ref_attention``), because a CPU
tensor means the caller asked for the CPU.  There is no fallback from the
one to the other.  The kernel reads q/k/v as contiguous, 16-byte aligned
arrays, so the wrapper makes them so: a no-op for the co-execution path,
whose ``kernel.attention`` node hands it ``q[:, None]`` views of
contiguous ``[B*H, S, D]`` tensors, and one copy of each strided or
misaligned input otherwise.  ``flash_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import entry, head_dim_instance, launch
from repro_torch.kernels.ref import ref_attention

NAME = "flash_attention"
Q_TILE = 64                         # query rows per CTA (csrc kBQ)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _aligned(t):
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B,H,Sq,D] and k/v "
                         f"[B,Hkv,Skv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"batch/head-dim mismatch: q {tuple(q.shape)}, "
                         f"kv {tuple(k.shape)}")
    Hkv = k.shape[1]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"GQA requires H % Hkv == 0 ({H}, {Hkv})")
    if window < 0:
        raise ValueError("window must be >= 0")
    return B, H, Hkv, Sq, k.shape[2], D


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,H,Sq,D]; k/v: [B,Hkv,Skv,D].  Returns [B,H,Sq,D] in q's
    dtype."""
    B, H, Hkv, Sq, Skv, D = _check(q, k, v, window)
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"flash_attention inputs span devices {devs}")
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash_attention kernel for "
                                  f"{q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    head_dim_instance(D, f"flash_attention q {tuple(q.shape)}, kv "
                         f"{tuple(k.shape)}")
    if Skv == 0:
        raise ValueError("flash_attention needs at least one key")
    if -(-Sq // Q_TILE) > 65535:
        raise ValueError(f"Sq={Sq} exceeds the kernel's grid "
                         f"({65535 * Q_TILE} query rows)")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B * H * Sq == 0:
        return out
    q, k, v = (_aligned(t) for t in (q, k, v))
    launch(flash_attention, entry(NAME, "repro_flash_attention", _ARGS),
           q.device, q, k, v, out, B, H, Hkv, Sq, Skv, D, int(bool(causal)),
           int(window), _DTYPES[q.dtype])
    return out


flash_attention.launches = 0
