"""Causal depthwise conv with its SiLU: the wrapper of the Hopper kernels.

``silu(sum_k ci[:, s + k] * w[:, k] + b)`` with ``ci = cat(window, x)``
along S (the Mamba-2 block's conv over its (x, B, C) columns, after the
last K-1 rows of the previous call or zeros), summed in f32 and rounded
once to x's dtype.  The kernels (``csrc/causal_conv.cu``, CUDA C++ for
``sm_90a``) replace no TPU kernel: the reference stacks K shifted windows
and contracts them with an einsum (``src/repro/models/ssm.py``), which on
the card became a [B, S, dc, K] copy and batched gemvs.  A CTA copies a
tile of 64 rows (and the K-1 before them) by 512 bytes of channels into
shared memory with ``cp.async``, then each thread computes 4 channels
down a run of the tile's rows with its taps in registers, so x is read
once and y written once.  :func:`causal_conv_bwd` is its gradient: one
kernel recomputes the pre-activation, writes dx (and the window's
gradient when asked) and one f32 partial of dw and db per CTA (4 tiles,
:data:`BWD_ROWS` rows); a second sums the partials in a fixed order (no
atomics: two calls give equal bits).  Each call counts as one launch
(``causal_conv.launches``, ``causal_conv_bwd.launches``).

The wrappers check device, dtypes and shapes and raise on anything the
kernels do not take (:func:`check_kernel_inputs`: K up to
:data:`MAX_K`, one dtype for every tensor, channels at unit stride).  A
CUDA tensor launches the kernels (or raises); a CPU or ``meta`` tensor
runs the plain versions (``ref.ref_causal_conv``, the block's stack and
einsum as the reference computes them, and ``ref.ref_causal_conv_bwd``),
because such a tensor means the caller asked for them.  There is no
fallback from the one to the other.  The kernels read x, the window and
dy through their batch and row strides (the model hands x as a view of
the in-projection's output, rows 3352 elements apart at mamba2-130m):
16-byte accesses where every pointer and row is 16-byte aligned, masked
element accesses otherwise (:func:`_vec_ok`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import entry, launch
from repro_torch.kernels.ref import ref_causal_conv, ref_causal_conv_bwd

NAME = "causal_conv"
MAX_K = 4                           # the kernels' largest template K
TILE_ROWS = 64                      # rows a tile (csrc kRows)
BWD_ROWS = 256                      # rows a gradient CTA (4 tiles)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entries' arguments (strides as 64-bit ints)
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
         + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def _check(x, w, b, window, what):
    """Shapes: x [B, S, dc], w [dc, K], b [dc] or None, window [B, K-1, dc]
    or None; one device."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"{what} takes x [B,S,dc] and w [dc,K]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    B, S, dc = x.shape
    K = w.shape[1]
    if b is not None and tuple(b.shape) != (dc,):
        raise ValueError(f"{what}: b must be [dc] = [{dc}], got "
                         f"{tuple(b.shape)}")
    if window is not None and tuple(window.shape) != (B, K - 1, dc):
        raise ValueError(f"{what}: window must be [B, K-1, dc] = "
                         f"{[B, K - 1, dc]}, got {tuple(window.shape)}")
    devs = {t.device for t in (x, w, b, window) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{what} inputs span devices {devs}")
    return B, S, dc, K


def check_kernel_inputs(x, w, b=None, window=None, dy=None):
    """Raise on what the kernels do not take: K above :data:`MAX_K`
    (ValueError), a dtype other than float32/bfloat16 or two dtypes among
    the tensors (TypeError), a channel axis of x, the window or dy that is
    not at unit stride (ValueError), or a grid too large.  The CUDA branch
    of each wrapper calls it; the plain versions take any of these."""
    B, S, dc, K = _check(x, w, b, window, "causal_conv")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the causal_conv kernels take K from 1 to {MAX_K} "
                         f"taps; got K={K}")
    ts = [t for t in (x, w, b, window, dy) if t is not None]
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ts):
        raise TypeError(f"the causal_conv kernels take float32 or bfloat16 "
                        f"tensors of one dtype; got "
                        f"{[str(t.dtype) for t in ts]}")
    for name, t in (("x", x), ("window", window), ("dy", dy)):
        if t is not None and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"the causal_conv kernels take {name} with its "
                             f"channels at unit stride; got strides "
                             f"{t.stride()}")
    if B > 65535 or -(-S // TILE_ROWS) > 65535:
        raise ValueError(f"B={B}, S={S} exceed the kernels' grid")
    return B, S, dc, K


def _vec_ok(*ts) -> bool:
    """Every tensor takes 16-byte accesses: aligned pointers, and strides
    (of axes longer than 1) and the channel count in 16-byte units."""
    el = ts[0].element_size()
    if ts[0].shape[-1] * el % 16:
        return False
    for t in ts:
        if t.data_ptr() % 16:
            return False
        if any(st * el % 16 for st, n in zip(t.stride()[:-1], t.shape[:-1])
               if n > 1):
            return False
    return True


def causal_conv(x, w, b=None, window=None):
    """x [B,S,dc] (channels at unit stride; any batch and row strides), w
    [dc,K], b [dc] or None, window [B,K-1,dc] or None (zeros) -> y
    [B,S,dc] in x's dtype."""
    B, S, dc, K = _check(x, w, b, window, "causal_conv")
    if x.device.type in ("cpu", "meta"):
        return ref_causal_conv(x, w, b, window)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no causal_conv kernel for {x.device}")
    check_kernel_inputs(x, w, b, window)
    y = torch.empty((B, S, dc), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    w = w.contiguous()
    b = None if b is None else b.contiguous()
    ts = [t for t in (x, window, y) if t is not None and t.numel()]
    sw = window.stride() if window is not None else (0, 0, 1)
    launch(causal_conv, entry(NAME, "repro_causal_conv", _ARGS), x.device,
           x, w, b, window if K > 1 else None, y, B, S, dc, K, x.stride(0),
           x.stride(1), sw[0], sw[1], _DTYPES[x.dtype], int(_vec_ok(*ts)))
    return y


causal_conv.launches = 0


def causal_conv_bwd(x, w, b, window, dy, *, want_window: bool = False):
    """The gradients of :func:`causal_conv` (shapes as there) for the
    cotangent ``dy`` [B,S,dc] of y -> (dx, dw, db, dwindow) in x's, w's,
    b's and the window's dtypes; db is None without a bias, dwindow None
    unless ``want_window`` (and a window was given).  The pre-activation
    is recomputed from the inputs.  A CUDA tensor launches the gradient
    kernel and the partials' sum (one launch in
    ``causal_conv_bwd.launches``) or raises; a CPU or ``meta`` tensor runs
    ``ref.ref_causal_conv_bwd``."""
    B, S, dc, K = _check(x, w, b, window, "causal_conv_bwd")
    if tuple(dy.shape) != (B, S, dc) or dy.device != x.device:
        raise ValueError(f"causal_conv_bwd takes dy shaped as x "
                         f"{tuple(x.shape)} on {x.device}; got "
                         f"{tuple(dy.shape)} on {dy.device}")
    want_window = want_window and window is not None
    if x.device.type in ("cpu", "meta"):
        return ref_causal_conv_bwd(x, w, b, window, dy,
                                   want_window=want_window)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no causal_conv_bwd kernel for "
                                  f"{x.device}")
    check_kernel_inputs(x, w, b, window, dy)
    dev = x.device
    dx = torch.empty((B, S, dc), dtype=x.dtype, device=dev)
    dw = torch.empty((dc, K), dtype=w.dtype, device=dev)
    db = None if b is None else torch.empty((dc,), dtype=b.dtype, device=dev)
    dwin = (torch.empty((B, K - 1, dc), dtype=x.dtype, device=dev)
            if want_window else None)
    if dx.numel() == 0:
        for t in (dx, dw, db, dwin):
            if t is not None:
                t.zero_()
        return dx, dw, db, dwin
    w = w.contiguous()
    b = None if b is None else b.contiguous()
    parts = B * -(-S // BWD_ROWS)
    part = torch.empty((parts, dc * (K + 1)), dtype=torch.float32,
                       device=dev)
    ts = [t for t in (x, window, dy, dx, dwin) if t is not None and t.numel()]
    sw = window.stride() if window is not None else (0, 0, 1)
    launch(causal_conv_bwd, entry(NAME, "repro_causal_conv_bwd", _BWD_ARGS),
           dev, x, w, b, window if K > 1 else None, dy, dx,
           dwin if K > 1 else None, part, dw, db, B, S, dc, K, x.stride(0),
           x.stride(1), sw[0], sw[1], dy.stride(0), dy.stride(1), parts,
           _DTYPES[x.dtype], int(_vec_ok(*ts)))
    return dx, dw, db, dwin


causal_conv_bwd.launches = 0
