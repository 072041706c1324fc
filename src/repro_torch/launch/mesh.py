"""Mesh construction: the production meshes (abstract) and device meshes.

``make_production_mesh`` returns an abstract mesh — axis names and sizes
only, no processes — which is all the spec rules read
(``parallel.specs``), so the production layout can be planned on any
machine.  ``make_mesh_for`` builds a ``torch.distributed`` ``DeviceMesh``
over the processes of the current group (``init_device_mesh``): CUDA
cards under NCCL, CPU processes under gloo.  Both are functions, so
importing this module touches no device and no process group.
"""

from __future__ import annotations

from repro_torch.parallel.specs import MeshView


def make_production_mesh(*, multi_pod: bool = False) -> MeshView:
    """Single pod: 16x16 = 256 cards (data, model).
    Multi-pod: 2 pods x 256 = 512 cards (pod, data, model)."""
    if multi_pod:
        return MeshView({"pod": 2, "data": 16, "model": 16})
    return MeshView({"data": 16, "model": 16})


def make_mesh_for(devices_per_axis: dict, device_type: str = None):
    """Build a ``DeviceMesh`` over the current process group, e.g.
    ``{'data': 4, 'model': 2}`` on 8 processes.  ``device_type``:
    ``"cuda"`` or ``"cpu"`` (default: the group's backend decides —
    NCCL means cuda)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(devices_per_axis.values()),
                            mesh_dim_names=tuple(devices_per_axis))


# Hardware constants for the roofline analysis: one NVIDIA H100 SXM5
# (80 GB HBM3), per card.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
#                                   (NVIDIA H100 data sheet; not measured)
HBM_BW = 3.35e12                  # bytes/s (H100 SXM5 data sheet; not
#                                   measured)
NVLINK_BW = 450e9                 # bytes/s per direction per card: NVLink
#                                   4, 18 links x 25 GB/s (data sheet's
#                                   900 GB/s bidirectional; not measured)
HBM_PER_CHIP = 80 * 10 ** 9       # bytes (H100 SXM5 data sheet: 80 GB)
