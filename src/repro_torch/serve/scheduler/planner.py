"""Step planner: choose prefill-vs-decode each loop iteration and build
the fixed-shape device frames for the chosen step.

Policy (vLLM-style continuous batching, prefill-priority): whenever free
slots exist and admissible requests are queued (and, for paged pools,
the block arena covers them — SlotPool.admit_checker), the next step is
an admission prefill; otherwise a masked decode step over the pool;
otherwise idle until the next arrival.

Frames are built so that device-facing shapes stay bounded:

* decode is a ``[max_slots]`` mask (plus the ``[max_slots, nbps]`` block
  table in paged mode) — one shape class forever.  The sampled-token
  frame itself is device-resident (pool_ops threads it variable-to-
  variable), so no host token value is needed to dispatch.
* prefill pads the prompt rows to the group's length bucket and the row
  *count* to a power of two by repeating the last real row (a duplicate
  scatter writes identical values — deterministic), so prefill compile
  variants stay O(log slots * log max_len).

Decode frames are **identity-stable**: the same ndarray objects are
re-handed out until pool membership or a token budget changes
(``mark_dirty`` / ``consume``).  The co-execution walker feeds by object
identity, so stable frames make every steady-state decode's argument
check a pointer comparison (executor/steady.py).

``budget`` tracks decode steps still owed per slot.  The pipelined
scheduler harvests tokens one step late, so it cannot see EOS/budget
exhaustion before dispatching the next step; masking a slot out the
moment its budget hits zero bounds the overshoot to the single post-EOS
garbage step the paged layout already reserves room for.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.executor.families import bucket_pow2


@dataclasses.dataclass
class PrefillPlan:
    requests: List[object]          # real (non-pad) rows, admission order
    bucket: int                     # padded prompt length
    tokens: np.ndarray              # [b_pow2, bucket] int32
    slots: np.ndarray               # [b_pow2] int32 (pads repeat the last)
    lengths: np.ndarray             # [b_pow2] int32 true prompt lengths
    bt_rows: Optional[np.ndarray] = None    # [b_pow2, nbps] paged tables


@dataclasses.dataclass
class DecodePlan:
    mask: np.ndarray                # [max_slots] bool rows to step
    bt: Optional[np.ndarray] = None         # [max_slots, nbps] block table


@dataclasses.dataclass
class IdlePlan:
    wait: Optional[float]           # seconds until next arrival, or None


class StepPlanner:
    def __init__(self, cfg, queue, pool, max_len: int, batch_cap: int,
                 bucket_floor: int = 8):
        self.cfg = cfg
        self.queue = queue
        self.pool = pool
        self.max_len = max_len
        self.batch_cap = batch_cap
        self.bucket_floor = bucket_floor
        # decode steps still owed per slot (max_new minus the prefill token)
        self.budget = np.zeros(pool.max_slots, np.int64)
        self._dirty = True
        self._mask_frame = np.zeros(pool.max_slots, bool)
        self._bt_frame: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def next_plan(self, now: float):
        admission = self.queue.pop_admission(
            now, self.pool.free_count, self.cfg, self.max_len,
            self.batch_cap, self.bucket_floor, self.pool.admit_checker())
        if admission is not None:
            return self._prefill_plan(*admission)
        if self._dirty:
            self._mask_frame = self.pool.active_mask() & (self.budget > 0)
            if self.pool.block_table is not None:
                self._bt_frame = self.pool.block_table.copy()
            self._dirty = False
        if self._mask_frame.any():
            return DecodePlan(self._mask_frame, self._bt_frame)
        nxt = self.queue.next_arrival()
        return IdlePlan(None if nxt is None else max(0.0, nxt - now))

    def consume(self, mask: np.ndarray) -> None:
        """Account one dispatched decode step against the masked slots'
        budgets; an exhausted budget invalidates the decode frames."""
        hit = mask & (self.budget > 0)
        self.budget[hit] -= 1
        if np.any(self.budget[hit] == 0):
            self._dirty = True

    def mark_dirty(self) -> None:
        """Pool membership changed (admission/retirement): rebuild the
        decode frames before the next decode dispatch."""
        self._dirty = True

    # ------------------------------------------------------------------
    def _prefill_plan(self, bucket: int, requests: List[object]):
        b = len(requests)
        b_pad = bucket_pow2(b)
        tokens = np.zeros((b_pad, bucket), np.int32)
        slots = np.zeros(b_pad, np.int32)
        lengths = np.zeros(b_pad, np.int32)
        for i, r in enumerate(requests):
            L = len(r.prompt)
            tokens[i, :L] = np.asarray(r.prompt, np.int32)
            slots[i] = self.pool.alloc(r, L)
            lengths[i] = L
            self.budget[slots[i]] = r.max_new_tokens - 1
        if b_pad > b:                       # pad rows: repeat the last real
            tokens[b:] = tokens[b - 1]
            slots[b:] = slots[b - 1]
            lengths[b:] = lengths[b - 1]
        bt_rows = None
        if self.pool.block_table is not None:
            bt_rows = self.pool.block_table[slots].copy()
        self._dirty = True
        return PrefillPlan(requests, bucket, tokens, slots, lengths, bt_rows)
