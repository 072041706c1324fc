"""Device-resident variable store (paper: resource inputs/outputs).

The authoritative buffer of every framework Variable lives here, not on the
Variable object: segments read ``var_in`` slices from the store and their
``var_out`` results are written back by the dispatcher, so variable state
flows GraphRunner-thread to GraphRunner-thread without ever bouncing
through Python.

Snapshot/restore implements the divergence-cancellation contract
(paper §4.1): at skeleton-iteration start the coordinator queues
``snapshot_into`` *on the runner thread* — after any still-pending work from
the previous iteration, so the snapshot sees committed state — and on
divergence the whole store is rolled back to that snapshot after a drain.
Snapshots hold buffer *references*, not copies; this is what makes
iteration-start buffers ineligible for donation (DESIGN.md §4.2) — donating
one would delete the only rollback copy.

Per-value readiness (DESIGN.md §4.4): dispatchers register, per variable,
the GraphRunner sequence number of the last submitted closure that reads or
writes it (``fence``).  A variable read then blocks only on its own last
writer — `runner.wait_for(seq)` — not on the whole queue, and a driver-side
rebind/release blocks only on its own last toucher.  The GraphRunner is a
FIFO, so a fence sequence completing implies every earlier closure
(including the writer the fence tracks) has also run; fences are plain
integers, allocated nowhere.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch.core.device import synchronize
from repro_torch.core.trace import as_tensor


class VariableStore:
    """var_id -> device buffer, plus the Variable registry.

    Buffers live on ``device``: a variable's initial value is staged there
    when it registers (the design's staging, not a fallback), and every
    value a driver rebinds goes through :meth:`stage`."""

    def __init__(self, device: torch.device = torch.device("cpu")):
        self.device = device
        self.buffers: Dict[int, Any] = {}
        self.vars: Dict[int, Any] = {}          # var_id -> Variable
        # released vars leave a (shape, dtype) tombstone: TraceGraph nodes
        # that read them survive as dead switch branches, and compiling
        # those branches still needs a placeholder input of the right aval
        self.tombstones: Dict[int, Any] = {}
        # per-variable readiness fences: var_id -> runner sequence number
        # (an already-completed sequence simply means "no pending work")
        self._write_fence: Dict[int, int] = {}
        self._use_fence: Dict[int, int] = {}
        # cached shape-class digest of the registry (families.py): rebuilt
        # lazily after any registration / release / aval rebind
        self._avals_digest: Optional[int] = None

    # -- per-value readiness (DESIGN.md §4.4) ------------------------------
    def fence(self, reads: Iterable[int], writes: Iterable[int],
              seq: int) -> None:
        """Register ``seq`` as the newest pending closure touching the
        given variables (called at submit time, on the Python thread)."""
        uf, wf = self._use_fence, self._write_fence
        for v in reads:
            uf[v] = seq
        for v in writes:
            wf[v] = seq
            uf[v] = seq

    def write_fence(self, var_id: int) -> Optional[int]:
        """Sequence of the last pending closure that writes ``var_id``."""
        return self._write_fence.get(var_id)

    def use_fence(self, var_id: int) -> Optional[int]:
        """Sequence of the last pending closure that reads or writes it."""
        return self._use_fence.get(var_id)

    # -- shape-class digest (families.py) ----------------------------------
    def avals_digest(self) -> int:
        """Hash of (var_id, aval) over the registry — the variable part of
        the family key.  A collision only merges two shape classes into one
        family, which the Walker then tells apart structurally (feed avals
        are part of node identity): cost is a divergence, never corruption."""
        d = self._avals_digest
        if d is None:
            d = hash(tuple(sorted((vid, v.aval)
                                  for vid, v in self.vars.items())))
            self._avals_digest = d
        return d

    def invalidate_avals(self) -> None:
        self._avals_digest = None

    # -- registry ----------------------------------------------------------
    def ensure(self, var) -> None:
        """Register ``var`` and seed its buffer from the initial value.  A
        registered variable whose buffer is missing (its first-ever write
        was rolled back by a divergence cancellation) is re-seeded: the
        initial value *is* its pre-iteration state."""
        if var.var_id not in self.vars:
            var._value = self.stage(var._value)
            self.vars[var.var_id] = var
            self.tombstones.pop(var.var_id, None)
            self._avals_digest = None
        if var.var_id not in self.buffers:
            self.buffers[var.var_id] = var._value

    def __contains__(self, var_id: int) -> bool:
        return var_id in self.buffers

    def get(self, var_id: int, default=None):
        return self.buffers.get(var_id, default)

    def put(self, var_id: int, value) -> None:
        self.buffers[var_id] = value

    def remove(self, var_id: int) -> None:
        """Unregister a variable and release its device buffer (drivers
        retiring state, e.g. serving caches whose shapes changed)."""
        buf = self.buffers.pop(var_id, None)
        self.vars.pop(var_id, None)
        self._avals_digest = None
        if buf is not None:
            self.tombstones[var_id] = (tuple(buf.shape), buf.dtype)

    def read(self, var_id: int):
        """Dispatch-time read: live buffer, or a zeros placeholder for a
        released var (reachable only from never-taken dead branches)."""
        buf = self.buffers.get(var_id)
        if buf is None:
            return self._zeros(var_id)
        return buf

    def read_initial(self, var_id: int):
        """Replay-time read: live buffer, else the variable's initial value
        (a fresh variable whose seed buffer was removed by rollback), else
        the released-var zeros placeholder."""
        buf = self.buffers.get(var_id)
        if buf is not None:
            return buf
        var = self.vars.get(var_id)
        if var is not None:
            return var._value
        return self._zeros(var_id)

    def _zeros(self, var_id: int):
        shape, dtype = self.tombstones[var_id]
        return torch.zeros(shape, dtype=dtype, device=self.device)

    # -- device ------------------------------------------------------------
    def stage(self, value):
        """``value`` as a tensor on the store's device (no copy when it is
        already there)."""
        return as_tensor(value, self.device)

    def synchronize(self) -> None:
        """Wait for the device work queued behind the buffers."""
        synchronize(self.device)

    # -- snapshot / rollback ----------------------------------------------
    def snapshot_into(self, snap: Dict[int, Any]) -> None:
        """Copy current buffer refs into ``snap`` (runner-thread closure)."""
        snap.update(self.buffers)

    def restore(self, snap: Dict[int, Any]) -> None:
        """Roll the store back to a snapshot (divergence cancellation)."""
        self.buffers.clear()
        self.buffers.update(snap)
