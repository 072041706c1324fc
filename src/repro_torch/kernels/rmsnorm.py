"""Fused RMSNorm: the wrapper of the Hopper kernel.

``x * rsqrt(mean(x^2) + eps) * (1 + g)`` per row, in f32, cast back to
x's dtype.  The kernel (``csrc/rmsnorm.cu``, CUDA C++ for ``sm_90a``)
replaces the TPU kernel ``src/repro/kernels/rmsnorm.py:_rmsnorm_kernel``:
one CTA per row, 16-byte loads where d allows, a block-wide sum of
squares.  x is ``[..., d]`` (leading axes flattened into rows), g ``[d]``.

The wrapper checks device, dtypes and shapes and raises on anything the
kernel does not take.  A CUDA tensor launches the kernel (or raises); a
CPU tensor runs the plain version (``ref.ref_rmsnorm``), because a CPU
tensor means the caller asked for the CPU.  There is no fallback from the
one to the other.  x is made contiguous (a copy only for a strided x; the
co-execution path's inputs are contiguous).  ``rmsnorm.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import ref_rmsnorm

NAME = "rmsnorm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 256


def _entry():
    from repro_torch.kernels.build import library
    fn = library(NAME).repro_rmsnorm
    if fn.argtypes is None:
        # pointers and the stream as c_void_p (a bare int would be cut)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch_shape(d: int, x: torch.Tensor, out: torch.Tensor):
    """(vec, threads): 16-byte vectors when d and both pointers allow,
    and enough threads (a multiple of 32, at most 256) to cover a row."""
    vec = 16 // x.element_size()
    if d % vec or x.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    threads = min(_MAX_THREADS, max(32, -(-(d // vec) // 32) * 32))
    return vec, threads


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
    vec, threads = _launch_shape(d, x, out)
    err = _entry()(x.data_ptr(), g.data_ptr(), out.data_ptr(), rows, d,
                   float(eps), _DTYPES[x.dtype], _DTYPES[g.dtype], vec,
                   threads, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
