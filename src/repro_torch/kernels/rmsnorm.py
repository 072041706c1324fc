"""Fused RMSNorm: the wrapper of the Hopper kernels.

``x * rsqrt(mean(x^2) + eps) * (1 + g)`` per row, in f32, cast back to
x's dtype.  The kernels (``csrc/rmsnorm.cu``, CUDA C++ for ``sm_90a``)
replace the TPU kernel ``src/repro/kernels/rmsnorm.py:_rmsnorm_kernel``.
x is ``[..., d]`` (leading axes flattened into rows), g ``[d]``.

:func:`launch_plan` picks one of two hand-written kernels from d and the
pointers' alignment, both static (never the data): where d is a multiple
of the 16-byte vector width, at most ``MAX_REG_D``, and x, out and g are
16-byte aligned, the register-resident kernel (each row read once from
HBM with a streaming hint, held in registers as 16-byte packs: one row
a CTA, 64 threads with 8 packs each at d = 4096 bf16, one barrier);
otherwise the generic two-pass kernel (one CTA a row; 16-byte loads of x
and g where d and the pointers allow).  This is a choice between two
kernels by shape, not a fallback.

The wrapper checks device, dtypes and shapes and raises on anything the
kernels do not take.  A CUDA tensor launches a kernel (or raises); a CPU
tensor runs the plain version (``ref.ref_rmsnorm``), because a CPU
tensor means the caller asked for the CPU.  There is no fallback from the
one to the other.  x is made contiguous (a copy only for a strided x; the
co-execution path's inputs are contiguous).  ``rmsnorm.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import entry, launch
from repro_torch.kernels.ref import ref_rmsnorm

NAME = "rmsnorm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 256                  # threads a row, generic kernel
MAX_REG_D = 8192                    # widest row the register kernel takes
_ROW_THREADS = 64                   # threads a row, register kernel
_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
         + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def launch_plan(d: int, x_el: int, aligned: bool):
    """(vec, threads, packs) for rows of ``d`` elements of ``x_el``
    bytes; ``aligned``: x, out and g start on 16 bytes.  Either kernel
    takes one row a CTA.

    packs > 0 selects the register-resident kernel: ``threads`` threads a
    row (a multiple of 32: 64, fewer for a short row, more where a row
    would need more than 8 packs a thread), each holding ``packs`` 16-byte
    packs (1, 2, 4 or 8).  packs == 0 selects the generic kernel: ``vec``
    elements a load (16 bytes where d and the pointers allow, else 1) and
    enough threads (a multiple of 32, at most 256) to cover a row."""
    vec = 16 // x_el
    if d % vec or not aligned:
        vec = 1
    nv = d // vec
    if vec > 1 and d <= MAX_REG_D:
        threads = min(_ROW_THREADS, -(-nv // 32) * 32)
        if -(-nv // threads) > 8:
            threads = -(-nv // 256) * 32          # 8 packs a thread
        need = -(-nv // threads)
        packs = next(p for p in (1, 2, 4, 8) if p >= need)
        return vec, threads, packs
    return vec, min(_MAX_THREADS, max(32, -(-nv // 32) * 32)), 0


def rmsnorm(x, g, *, eps: float = 1e-6):
    """x: [..., d]; g: [d].  Returns x's shape and dtype."""
    if x.dim() < 1 or g.dim() != 1 or g.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm takes x [..., d] and g [d], got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.device != g.device:
        raise ValueError(f"rmsnorm inputs span devices {x.device}, "
                         f"{g.device}")
    if x.device.type == "cpu":
        return ref_rmsnorm(x, g, eps)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no rmsnorm kernel for {x.device}")
    if x.dtype not in _DTYPES or g.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x and g, got "
                        f"{x.dtype}/{g.dtype}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    x = x.contiguous()
    g = g.contiguous()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out, g))
    vec, threads, packs = launch_plan(d, x.element_size(), aligned)
    launch(rmsnorm, entry(NAME, "repro_rmsnorm", _ARGS), x.device, x, g,
           out, rows, d, float(eps), _DTYPES[x.dtype], _DTYPES[g.dtype], vec,
           threads, packs)
    return out


rmsnorm.launches = 0
