"""Hand-written Hopper kernels and their plain PyTorch versions.

    paged_attention — single-token paged decode attention, CUDA C++ for
                      sm_90a (csrc/paged_attention.cu), bound by ctypes
    build.py        — nvcc build at first use into kernels/_build/
    ref.py          — plain versions: the CPU path and the ground truth
    ops.py          — the entry points the model and kernel_sub call

The rmsnorm, flash_attention and ssd_scan kernels of the reference wait
for later slices of the port.
"""

# ``paged_attention`` stays the submodule's name here (its wrapper carries
# the launch counter): call it as kernels.ops.paged_attention or
# kernels.paged_attention.paged_attention
from repro_torch.kernels.ops import flash_attention, rmsnorm

__all__ = ["flash_attention", "rmsnorm"]
