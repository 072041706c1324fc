"""Paged KV-cache layout: fixed-size blocks + per-slot block tables.

The dense pool stores `[max_slots, max_len]` cache rows, so memory
scales with the *worst case* of every slot.  The paged pool (DESIGN.md
§12) stores a flat arena of `num_blocks` fixed-size blocks and gives
each slot a block table `[nbps]` mapping logical block index -> arena
block id.  Admission capacity is then bounded by *tokens resident*
(prompt + generation budget), not by `max_slots x max_len`.

Block 0 is reserved as the trash block: released slots have their block
table zeroed, so a decode step that is still in flight for a retired
slot (the scheduler runs one step deep) scatters its garbage write into
block 0, which is never read.  The same trick absorbs the one garbage
step a slot executes after its EOS is detected one harvest late — the
`+ 1` in ``blocks_needed`` reserves room for that write so it can never
land in another request's block.
"""

from __future__ import annotations

from typing import List, Optional


class PagedLayout:
    """Static geometry of the paged arena."""

    def __init__(self, block_size: int, num_blocks: int, max_len: int):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if max_len % block_size:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of "
                f"block_size ({block_size})")
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is trash)")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_len = max_len
        # blocks-per-slot: block-table width (logical address space)
        self.nbps = max_len // block_size

    def blocks_needed(self, length: int, max_new: int) -> int:
        """Blocks to reserve for a request: prompt + generation budget
        + 1 position for the post-EOS garbage decode step."""
        tokens = length + max_new + 1
        return -(-tokens // self.block_size)        # ceil division


class BlockAllocator:
    """Free-list allocator over the arena; block 0 is never handed out.

    Allocation is all-or-nothing (``alloc`` returns None when the pool
    cannot cover the request) so admission backpressure is a clean
    queue-and-wait, never a partial grant.  Lowest-index-first keeps
    replays of the same workload deterministic, mirroring SlotPool.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is trash)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(1, num_blocks))

    @property
    def capacity(self) -> int:
        """Total allocatable blocks (arena minus the trash block)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks, lowest-first; None if they don't all fit."""
        if n < 0:
            raise ValueError("cannot allocate a negative block count")
        if n > len(self._free):
            return None
        self._free.sort()
        taken, self._free = self._free[:n], self._free[n:]
        return taken

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b <= 0 or b >= self.num_blocks:
                raise ValueError(f"block id {b} outside arena")
            if b in self._free:
                raise RuntimeError(f"double free of block {b}")
        self._free.extend(blocks)
