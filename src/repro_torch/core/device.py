"""Where the port runs: the CUDA card unless the caller asks for another.

Every entry point (``function``, ``imperative``, ``init_params``, the
serving scheduler) takes ``device=None``, resolved here.  ``None`` means
the card; without one the call raises — nothing drops to the CPU unless
the caller passed ``device="cpu"`` itself.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev


def synchronize(device: torch.device) -> None:
    """Block until the device's queued work has finished (no-op on the
    CPU, where every op has finished when it returns)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
