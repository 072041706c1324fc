"""Trace representation for Terra's tracing phase.

A *trace* is the linear chain of DL operations recorded while the Python
interpreter executes one iteration of an imperative program (paper §4.1).
Each entry records the op type, its attributes, the *program location* where
it was executed (the paper's third equality criterion, Appendix A), the
data-flow references of its inputs, and the abstract values of its outputs.

References
----------
``Ref``      output ``out_idx`` of the trace entry with ordinal ``entry``.
``FeedRef``  an external tensor fed from the Python side (paper: *feed point*
             / *Input Feeding* op).  Identity is structural: the consuming
             (entry, arg position) pair.
``VarRef``   the value of a framework Variable at iteration start (resource
             input slot).  Assignments later in the trace re-bind the
             variable to an ordinary ``Ref``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Optional, Tuple

import numpy as np
import torch

_CORE_DIR = os.path.dirname(os.path.abspath(__file__))


# --------------------------------------------------------------------------
# References
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ref:
    """Output ``out_idx`` of trace entry ``entry`` (ordinal in the trace)."""
    entry: int
    out_idx: int


@dataclasses.dataclass(frozen=True)
class FeedRef:
    """External tensor fed by the Python side at (consumer entry, arg pos)."""
    entry: int
    arg_pos: int


@dataclasses.dataclass(frozen=True)
class VarRef:
    """A Variable's value at iteration start."""
    var_id: int


AnyRef = Any  # Ref | FeedRef | VarRef


# --------------------------------------------------------------------------
# Abstract values
# --------------------------------------------------------------------------

# 64-bit host values are narrowed as the reference's default (x64-off)
# mode narrows them, so a numpy feed has the same aval in both packages
_NARROW = {np.dtype(np.float64): torch.float32,
           np.dtype(np.int64): torch.int32}


def torch_dtype(dt) -> torch.dtype:
    """A ``torch.dtype`` for a torch dtype, a numpy dtype or a name."""
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str) and isinstance(getattr(torch, dt, None),
                                          torch.dtype):
        return getattr(torch, dt)
    dt = np.dtype(dt)
    return _NARROW.get(dt) or torch.from_numpy(np.empty(0, dt)).dtype


def dtype_name(dt) -> str:
    """Canonical short name ("float32", "bfloat16") — the hashable form
    dtype attributes take in op signatures."""
    return str(torch_dtype(dt)).replace("torch.", "")


def as_tensor(v, device=None) -> torch.Tensor:
    """A torch tensor of ``v`` (tensor, numpy array or scalar), on
    ``device`` when given; numpy data is shared where dtype and device
    allow (the CPU staging path copies nothing)."""
    if isinstance(v, torch.Tensor):
        return v if device is None else v.to(device)
    a = np.asarray(v)
    dt = torch_dtype(a.dtype)
    if a.dtype in _NARROW:
        a = a.astype(np.float32 if a.dtype.kind == "f" else np.int32)
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)


def to_numpy(v) -> np.ndarray:
    """Host copy of a tensor (bf16 widens to f32, numpy has no bf16)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(v)


@dataclasses.dataclass(frozen=True)
class Aval:
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @staticmethod
    def of(x) -> "Aval":
        if isinstance(x, torch.Tensor):
            return Aval(tuple(x.shape), x.dtype)
        a = np.asarray(x)
        return Aval(tuple(a.shape), torch_dtype(a.dtype))


# --------------------------------------------------------------------------
# Trace entries
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TraceEntry:
    """One recorded DL operation.

    ``signature`` (op_name, attrs, location) is the paper's node-equality
    key (Appendix A); we additionally compare input refs at merge time (see
    tracegraph.py and DESIGN.md §7 for why this conservative extension is
    sound).
    """
    op_name: str
    attrs: Tuple[Tuple[str, Any], ...]     # sorted, hashable
    location: Tuple[str, int]              # (filename, lineno) of user code
    input_refs: Tuple[AnyRef, ...]
    out_avals: Tuple[Aval, ...]
    feed_avals: Tuple[Tuple[int, Aval], ...] = ()   # (arg_pos, aval) of feeds

    def signature(self) -> Tuple:
        return (self.op_name, self.attrs, self.location)

    def stamp(self) -> Optional[int]:
        """Entry-signature hash for the Walker's steady-state fast path
        (DESIGN.md §4.4): the full recorded identity of the entry —
        signature plus raw ordinal-based input refs and feed avals — folded
        to one integer.  ``merge_trace`` stamps the matched TraceGraph node
        with this value, so a later identical iteration validates the op
        with a single cached-hash comparison instead of resolving every
        input source.  Returns None when a constant input is unhashable
        (the Walker then always takes the structural path)."""
        try:
            return hash((self.op_name, self.attrs, self.location,
                         self.input_refs, self.feed_avals))
        except TypeError:
            return None


@dataclasses.dataclass
class SyncMarker:
    """Materialization event: Python required the value of ``ref`` before
    issuing the next op.  Segment boundaries are derived from these (paper's
    *Output Fetching* points that gate the PythonRunner)."""
    ref: AnyRef


@dataclasses.dataclass
class VarAssign:
    """Variable ``var_id`` re-bound to ``ref`` (Python object mutation that
    the symbolic graph must honor — Figure 1c class of programs)."""
    var_id: int
    ref: AnyRef


@dataclasses.dataclass
class Trace:
    """A single iteration's recording."""
    entries: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)   # in-order ops/markers/assigns
    fetches: list = dataclasses.field(default_factory=list)  # refs materialized
    var_reads: set = dataclasses.field(default_factory=set)
    var_assigns: dict = dataclasses.field(default_factory=dict)  # var_id -> final ref

    def add_entry(self, e: TraceEntry) -> int:
        idx = len(self.entries)
        self.entries.append(e)
        self.events.append(e)
        return idx


# --------------------------------------------------------------------------
# Program-location capture
# --------------------------------------------------------------------------

def user_location(skip_files: Tuple[str, ...] = ()) -> Tuple[str, int]:
    """Innermost stack frame outside repro_torch.core (and ``skip_files``).

    This is the paper's "location of the program" equality criterion: two
    dynamic occurrences of an op are the same *node* only if they were
    executed from the same source location.
    """
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_CORE_DIR) and fn not in skip_files:
            return (fn, f.f_lineno)
        f = f.f_back
    return ("<unknown>", 0)


def is_tensor_like(x) -> bool:
    """External array data (numpy / torch) that should become a feed point."""
    return isinstance(x, (np.ndarray, torch.Tensor))
