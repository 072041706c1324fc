"""Build the hand-written CUDA kernels, bind them with ctypes and launch
them.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled on
first use, from the repo's sources only, by ``nvcc`` for ``sm_90a`` into
``kernels/_build/`` (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<digest>.so csrc/<name>.cu

The library name carries a digest of the source, so an edited kernel is
rebuilt and a built one is reused within a checkout.  :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them together;
the first use of a source one model block shares with another
(:data:`TOGETHER`) builds both so.

Every wrapper goes through :func:`entry` (a library symbol with the
argument types its wrapper declares) and :func:`launch` (the call on the
current stream of the tensors' device, a CUDA error raised by
:func:`call`, the launch counted).  Nothing here runs at import time:
the CPU tests import every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# sources one model block needs together, built at once on the first use
# of either: the Mamba-2 block runs the SSD scan and the causal conv
TOGETHER = {"ssd_scan": ("ssd_scan", "causal_conv"),
            "causal_conv": ("causal_conv", "ssd_scan")}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
LOGS: Dict[str, str] = {}           # name -> nvcc output of its last build
_RECORDING = threading.local()      # .rec: this thread's launches, or None
_CAPTURE_RECS: List[dict] = []      # the records open in this process


# head dims the attention kernels are instantiated for; any other D up to
# 256 that is a multiple of 8 runs in the next one, its extra columns
# masked in the loads (csrc flash_attention.cu, paged_attention.cu)
HEAD_DIMS = (16, 32, 64, 128, 256)


def head_dim_instance(D: int, what: str) -> int:
    """The instantiated head dim that runs D; raises, naming ``what`` (the
    call's shapes), for any D the kernels do not take."""
    if D <= 0 or D > HEAD_DIMS[-1] or D % 8:
        raise ValueError(f"{what}: the kernel takes head dims up to "
                         f"{HEAD_DIMS[-1]} that are multiples of 8, got "
                         f"D={D}")
    return next(d for d in HEAD_DIMS if d >= D)


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: adds one to ``wrapper.launches``
    and to the calling thread's record while it has one open.  A thread
    with no record of its own whose current stream is being captured
    (autograd's device thread running a captured backward) counts into
    the innermost open record: one capture runs at a time."""
    wrapper.launches += 1
    rec = getattr(_RECORDING, "rec", None)
    if rec is None and _CAPTURE_RECS and _stream_capturing():
        rec = _CAPTURE_RECS[-1]
    if rec is not None:
        rec[wrapper] = rec.get(wrapper, 0) + 1


def _stream_capturing() -> bool:
    """Whether this thread's current CUDA stream is being captured."""
    import torch
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def recording_launches():
    """Yield {wrapper: launches} counted by this thread — and by other
    threads into the stream it captures — while the block runs (a CUDA
    graph capture: other threads' eager launches are not in it)."""
    prev = getattr(_RECORDING, "rec", None)
    _RECORDING.rec = rec = {}
    _CAPTURE_RECS.append(rec)
    try:
        yield rec
    finally:
        _CAPTURE_RECS.remove(rec)
        _RECORDING.rec = prev


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _paths(name: str):
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source not built yet, in parallel; returns the
    wall seconds of each build that ran.  Raises with nvcc's output when a
    build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List = []
    for name in names:
        src, lib = _paths(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc()] + NVCC_FLAGS + ["-o", tmp, src]
        procs.append((name, lib, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    done: Dict[str, float] = {}
    failed = []
    for name, lib, tmp, t0, p in procs:
        out, _ = p.communicate()
        LOGS[name] = out
        if p.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, lib)
        done[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def entry(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of kernel library ``name`` (built first if
    needed), taking ``argtypes`` and returning an int (a cudaError_t).
    Pointers and the stream are ``c_void_p`` there: a bare Python int
    would be passed as a 32-bit int and cut the pointer."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def call(what: str, fn, *args) -> None:
    """``fn(*args)``; raises, naming ``what``, on a nonzero return (a
    cudaError_t)."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def launch(wrapper, fn, device, *args) -> None:
    """``fn(*args, stream)`` on the current CUDA stream of ``device``, a
    tensor among ``args`` passed as its data pointer; raises on a nonzero
    return, else counts one launch of ``wrapper``'s kernel."""
    import torch
    call(f"{wrapper.__name__} kernel launch", fn,
         *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
         torch.cuda.current_stream(device).cuda_stream)
    count_launch(wrapper)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed (with
    the sources :data:`TOGETHER` names beside it)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all(TOGETHER.get(name, (name,)))
            lib = _LIBS[name] = ctypes.CDLL(_paths(name)[1])
    return lib
