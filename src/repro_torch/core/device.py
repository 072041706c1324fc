"""Where the port runs: the CUDA card unless the caller asks for another.

Every entry point (``function``, ``imperative``, ``init_params``, the
serving scheduler) takes ``device=None``, resolved here.  ``None`` means
the card; without one the call raises — nothing drops to the CPU unless
the caller passed ``device="cpu"`` itself.
"""

from __future__ import annotations

import time

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


class SegmentTimer:
    """Sampled device-time attribution of one call (DESIGN.md §15).

    Made just before the call and stopped just after, on the thread that
    makes it.  ``stop`` returns ``(dispatch, device)`` seconds: the host
    time the call took to return, and the device time of the work it
    queued.  On a CUDA card the device time is the elapsed time between
    two CUDA events recorded on the caller's current stream around the
    call (a captured graph's warm-up and capture run on a side stream that
    the current stream waits on, so the end event covers them too); it
    leaves out work queued ahead of the call.  On the CPU every op has
    finished when the call returns, and the device time is the call's
    host wall, as in the reference."""

    __slots__ = ("device", "t0", "start")

    def __init__(self, device: torch.device):
        self.device = device
        self.start = None
        if device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(device))
        self.t0 = time.perf_counter()

    def stop(self):
        t1 = time.perf_counter()
        if self.start is None:
            return t1 - self.t0, time.perf_counter() - self.t0
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.device))
        end.synchronize()
        return t1 - self.t0, self.start.elapsed_time(end) / 1e3
