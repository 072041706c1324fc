"""Hand-written Hopper kernels and their plain PyTorch versions.

    paged_attention — single-token paged decode attention
                      (csrc/paged_attention.cu)
    rmsnorm         — fused single-pass RMSNorm (csrc/rmsnorm.cu)
    flash_attention — causal/SWA/GQA online-softmax attention
                      (csrc/flash_attention.cu)
    ssd_scan        — Mamba-2 SSD chunked scan with an optional final
                      state, and its gradient ``ops.ssd_scan_bwd``
                      (csrc/ssd_scan.cu)
    causal_conv     — Mamba-2's causal depthwise conv with its bias and
                      SiLU, and its gradient ``ops.causal_conv_bwd``
                      (csrc/causal_conv.cu)
    build.py        — nvcc build (sm_90a) at first use into kernels/_build/,
                      bound by ctypes
    ref.py          — plain versions: the CPU path and the ground truth
    ops.py          — the entry points the model and kernel_sub call
"""

# as in the reference, the package exports the rmsnorm, flash_attention
# and ssd_scan wrappers (which shadow their submodules' names; each
# wrapper carries its launch counter).  ``paged_attention`` stays the
# submodule's name here: call it as kernels.ops.paged_attention.
from repro_torch.kernels.ops import flash_attention, rmsnorm, ssd_scan

__all__ = ["flash_attention", "rmsnorm", "ssd_scan"]
