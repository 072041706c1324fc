"""Kernel entry points the model and the pass pipeline call.

``paged_attention`` launches the hand-written Hopper kernel on CUDA
tensors.  The rmsnorm and flash-attention kernels (reference:
``src/repro/kernels/rmsnorm.py``, ``flash_attention.py``) arrive in a later
slice: until then their wrappers run the plain versions for CPU tensors —
the caller asked for the CPU — and raise for CUDA tensors; the pass
pipeline does not substitute them on the card (passes/kernel_sub.py).
"""

from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.paged_attention import paged_attention

__all__ = ["paged_attention", "rmsnorm", "flash_attention"]


def _cpu_only(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cpu":
            raise NotImplementedError(
                f"the {name} kernel for {t.device.type} arrives in a later "
                f"slice of the port")


def rmsnorm(x, g, *, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + g)``, f32 inside."""
    _cpu_only("rmsnorm", x, g)
    return _ref.ref_rmsnorm(x, g, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,H,Sq,D]; k/v: [B,Hkv,Skv,D] -> [B,H,Sq,D]."""
    _cpu_only("flash_attention", q, k, v)
    return _ref.ref_attention(q, k, v, causal=causal, window=window)
