"""Slot bookkeeping for the pooled KV cache.

The pool's *device* state (cache leaves, per-slot position counters)
lives as framework Variables inside the scheduler; this module is the
pure-Python side: a free list, the slot -> request binding, and host
mirrors of the per-slot counters so the planner never has to fetch
device state to make a scheduling decision.  All of it is exactly the
kind of imperative per-request bookkeeping the co-execution runtime
exists to keep cheap (PAPER.md): it runs on the Python thread while the
GraphRunner executes the queued decode step.

With a :class:`~repro_torch.serve.scheduler.paged.PagedLayout` attached, each
slot additionally owns a row of the host block table: admission reserves
``blocks_needed(prompt, budget)`` arena blocks (all-or-nothing),
retirement returns them and zeroes the row so any still-in-flight decode
write for the retired slot lands in the trash block (DESIGN.md §12).
Capacity is then bounded by tokens *resident*, not slots.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.serve.scheduler.paged import BlockAllocator, PagedLayout


class SlotPool:
    """Fixed pool of ``max_slots`` cache rows with free-list allocation.

    Slots are handed out lowest-index-first so replays of the same
    workload are deterministic; releasing a slot returns it to the pool
    immediately (the device row is only ever overwritten by the next
    prefill into it — no clearing pass is needed, stale entries beyond a
    row's position counter are masked at every read).
    """

    def __init__(self, max_slots: int, layout: Optional[PagedLayout] = None,
                 row_tokens: int = 0):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self._free: List[int] = list(range(max_slots))
        self.requests: List[Optional[object]] = [None] * max_slots
        # host mirror of the device position counters (prompt length +
        # generated tokens); authoritative for planning, never fetched
        self.pos = np.zeros(max_slots, np.int32)
        # dense pools reserve a full cache row per active slot; counting
        # ``row_tokens`` (the scheduler's max_len) per allocation makes
        # resident/peak tokens comparable with the paged arena's
        # block-granular accounting below
        self.row_tokens = row_tokens
        self.layout = layout
        self.allocator: Optional[BlockAllocator] = None
        self.block_table: Optional[np.ndarray] = None
        self.resident_tokens = 0
        self.peak_resident_tokens = 0
        if layout is not None:
            self.allocator = BlockAllocator(layout.num_blocks)
            self.block_table = np.zeros((max_slots, layout.nbps), np.int32)

    # ------------------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.max_slots - len(self._free)

    def active_mask(self) -> np.ndarray:
        return np.array([r is not None for r in self.requests], bool)

    def active_items(self):
        """(slot, request) pairs for every occupied slot, in slot order."""
        return [(i, r) for i, r in enumerate(self.requests) if r is not None]

    # ------------------------------------------------------------------
    def alloc(self, request, length: int) -> int:
        """Bind ``request`` to the lowest free slot; returns the slot id.

        Paged pools also reserve the request's block budget here —
        all-or-nothing, so a failed reservation leaves no partial state.
        Callers gate admission on :meth:`admit_checker`, making the
        RuntimeError a genuine invariant violation, not backpressure.
        """
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        slot = min(self._free)
        if self.layout is not None:
            need = self.layout.blocks_needed(
                length, getattr(request, "max_new_tokens", 0))
            blocks = self.allocator.alloc(need)
            if blocks is None:
                raise RuntimeError(
                    f"block arena exhausted ({need} blocks needed, "
                    f"{self.allocator.free_count} free)")
            row = self.block_table[slot]
            row[:] = 0
            row[:need] = blocks
            self.resident_tokens += need * self.layout.block_size
        else:
            self.resident_tokens += self.row_tokens
        self.peak_resident_tokens = max(self.peak_resident_tokens,
                                        self.resident_tokens)
        self._free.remove(slot)
        self.requests[slot] = request
        self.pos[slot] = length
        return slot

    def release(self, slot: int) -> None:
        if self.requests[slot] is None:
            raise RuntimeError(f"double free of slot {slot}")
        if self.layout is not None:
            row = self.block_table[slot]
            blocks = [int(b) for b in row[row > 0]]
            self.allocator.free(blocks)
            row[:] = 0
            self.resident_tokens -= len(blocks) * self.layout.block_size
        else:
            self.resident_tokens -= self.row_tokens
        self.requests[slot] = None
        self._free.append(slot)

    def advance_active(self, mask: Optional[np.ndarray] = None) -> None:
        """Mirror one masked decode step: masked rows advance by one
        (default: every active row)."""
        if mask is None:
            mask = self.active_mask()
        self.pos += np.asarray(mask, bool).astype(np.int32)

    # ------------------------------------------------------------------
    def admit_checker(self):
        """Admission-capacity predicate for one planning pass, or None
        when the pool is dense (slots are the only capacity axis).

        The returned closure is *stateful*: each accepted request
        decrements the remaining block budget, so a single admission
        group can never overcommit the arena."""
        if self.layout is None:
            return None
        remaining = self.allocator.free_count
        layout = self.layout

        def fits(req) -> bool:
            nonlocal remaining
            need = layout.blocks_needed(len(req.prompt), req.max_new_tokens)
            if need > remaining:
                return False
            remaining -= need
            return True

        return fits
