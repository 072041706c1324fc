"""Kernel entry points the model and the pass pipeline call.

Each launches its hand-written Hopper kernel (CUDA C++ for ``sm_90a``) on
CUDA tensors and runs its plain version on CPU tensors, because the caller
asked for the CPU; any other device raises:

    paged_attention — paged single-token decode (csrc/paged_attention.cu)
    rmsnorm         — fused RMSNorm (csrc/rmsnorm.cu)
    flash_attention — causal / window / GQA attention
                      (csrc/flash_attention.cu)
    ssd_scan        — Mamba-2 SSD chunked scan, optional final state
                      (csrc/ssd_scan.cu)
    ssd_scan_bwd    — its gradient, for the cotangents of y and the final
                      state (csrc/ssd_scan.cu)
    causal_conv     — the Mamba-2 block's causal depthwise conv with its
                      bias and SiLU (csrc/causal_conv.cu)
    causal_conv_bwd — its gradient: dx, dw, db and the window's
                      (csrc/causal_conv.cu)

Each name is the wrapper function itself, so ``ops.rmsnorm.launches`` is
the kernel's launch counter.
"""

from __future__ import annotations

from repro_torch.kernels.causal_conv import causal_conv, causal_conv_bwd
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

__all__ = ["paged_attention", "rmsnorm", "flash_attention", "ssd_scan",
           "ssd_scan_bwd", "causal_conv", "causal_conv_bwd"]
