"""Variable surface of the TerraEngine: reads, assigns, out-of-band
rebinds, RNG and the per-value fence wait.

Split out of coordinator.py as a mixin for the same reason
python_runner.py is one — the phase machine and the variable API are
independently readable, and the coordinator stays within the executor's
module-size budget.  Everything here operates on the engine's own state
(store, mode, bindings, event stream).  Fenced *device-side* variable
updates (the serving prefill path) live in varops.py.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import ops as ops_mod
from repro_torch.core.events import emit as ev
from repro_torch.core.executor import steady
from repro_torch.core.tensor import TerraTensor, Variable
from repro_torch.core.trace import Aval, Ref, VarAssign, VarRef

SKELETON = "skeleton"


class VariableOps:
    """Mixin for TerraEngine: the variable-facing API."""

    def _ensure_var(self, var: Variable):
        self.store.ensure(var)

    def read_variable(self, var: Variable) -> TerraTensor:
        self._ensure_var(var)
        bound = self._var_binding.get(var.var_id)
        if bound is not None:
            return bound
        if self.mode == SKELETON:
            return TerraTensor(VarRef(var.var_id), var.aval, engine=self,
                               iter_id=self.iter_id)
        # eager modes read the committed store value
        return TerraTensor(VarRef(var.var_id), var.aval,
                           eager=self.store.get(var.var_id, var._value),
                           engine=self, iter_id=self.iter_id)

    def assign_variable(self, var: Variable, value):
        self._ensure_var(var)
        if not isinstance(value, TerraTensor):
            value = ops_mod.identity(value)
        if not isinstance(value.ref, Ref) or value._iter != self.iter_id:
            value = ops_mod.identity(value)
        self.trace.events.append(VarAssign(var.var_id, value.ref))
        self.trace.var_assigns[var.var_id] = value.ref
        self._var_binding[var.var_id] = value

    def _await_fence(self, seq) -> None:
        """Block on one per-value readiness fence (DESIGN.md §4.4) — a
        GraphRunner sequence number — instead of draining the whole queue;
        the FIFO runner guarantees the fenced writer has committed its
        buffer once the sequence completes.  Lazy mode executes the queued
        work on this thread, as drain() used to."""
        if seq is None or self.runner.done(seq):
            return
        with self.events.span("engine.fetch", seq=seq):
            t0 = time.perf_counter()
            self.runner.wait_for(seq)
            self.events.add("py_stall_time", time.perf_counter() - t0)

    def variable_value(self, var: Variable):
        self._ensure_var(var)
        if self._iter_open and self.mode == SKELETON:
            # Python saw device state: poison the steady-state plan (§12)
            if not getattr(self, "_steady_poison", False):
                ev.steady_poison(self.events, self.iter_id)
            self._steady_poison = True
        bound = self._var_binding.get(var.var_id)
        if bound is not None and bound._eager is not None:
            return bound._eager
        # block only on this variable's last pending writer (not the queue)
        self._await_fence(self.store.write_fence(var.var_id))
        val = self.store.buffers[var.var_id]
        if (self._iter_open and self.mode == SKELETON and self.gp is not None
                and var.var_id in self.gp.donatable_var_ids) \
                or steady.donates(self, var.var_id):
            # a later segment of this iteration, or a steady iteration's
            # twin, may write this buffer in place; hand the caller a
            # private copy (DESIGN.md §4.2)
            val = val.clone()
        return val

    def variable_read_ref(self, var: Variable):
        return VarRef(var.var_id)

    def reset_variable(self, var: Variable, value):
        """Out-of-band variable (re)binding between iterations — used by
        drivers (e.g. the serving engine rebinding KV-cache variables after
        a prefill) to swap device state without recording a trace event.
        Rebinding to a different shape is legal: the new aval flows into
        the store's shape digest, so the next iteration selects (or traces)
        the matching TraceGraph family (§8) instead of diverging."""
        if self._iter_open and self.mode == SKELETON:
            raise RuntimeError("reset_variable inside an open co-executed "
                               "iteration")
        self._ensure_var(var)
        # wait for the last pending toucher (reader or writer) of this
        # variable only; rebinds between iterations no longer serialize
        # behind the whole previous iteration's queue
        self._await_fence(self.store.use_fence(var.var_id))
        staged = self.store.stage(value)
        if staged is value and steady.donates(self, var.var_id):
            staged = staged.clone()     # a steady twin writes it in place
        value = staged
        self.store.put(var.var_id, value)
        var._value = value
        new_aval = Aval.of(value)
        if new_aval != var.aval:
            var.aval = new_aval
            self.store.invalidate_avals()

    def release_variable(self, var: Variable) -> None:
        """Drop a variable's buffer from the store (driver-retired state)."""
        self._await_fence(self.store.use_fence(var.var_id))
        self.store.remove(var.var_id)

    # ------------------------------------------------------------------
    # RNG
    # ------------------------------------------------------------------
    def next_rng_key(self):
        """The key feed of the iteration's next random op: a pure function
        of (seed, iteration, draw count), as the reference's fold_in chain
        is, so a replayed iteration draws the same keys."""
        seed = np.random.SeedSequence(
            [self._seed, self.iter_id + 1, self._rng_count]).generate_state(1)
        self._rng_count += 1
        return ops_mod.draw_key(torch.Generator().manual_seed(int(seed[0])))
