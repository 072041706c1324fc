"""Continuous-batching serving scheduler with a slot-pooled KV cache.

    scheduler.py  — ContinuousBatchingScheduler, the co-executed main loop
    planner.py    — prefill-vs-decode step planning + fixed-shape frames
    slots.py      — SlotPool free-list allocation + host position mirrors
    paged.py      — paged arena layout + block-table allocation
    lifecycle.py  — arrivals, length bucketing, retirement, streaming
    pool_ops.py   — serve.slot_prefill / serve.slot_decode DL operations
    telemetry.py  — the scheduler's counters and events on the stream

Quiescent checkpoint/restore (the reference's checkpoint.py) arrives with
the port's persistence slice.

See DESIGN.md §11/§12 for the architecture and shape-stability argument.
"""

from repro_torch.serve.scheduler.lifecycle import (ArrivalQueue, CallbackQueue,
                                             bucket_len, record_token)
from repro_torch.serve.scheduler.paged import BlockAllocator, PagedLayout
from repro_torch.serve.scheduler.planner import (DecodePlan, IdlePlan,
                                           PrefillPlan, StepPlanner)
from repro_torch.serve.scheduler.pool_ops import (build_pool_cache,
                                            check_supported, pads_allowed,
                                            slot_decode, slot_prefill)
from repro_torch.serve.scheduler.scheduler import ContinuousBatchingScheduler
from repro_torch.serve.scheduler.slots import SlotPool

__all__ = [
    "ContinuousBatchingScheduler", "SlotPool", "StepPlanner",
    "ArrivalQueue", "CallbackQueue", "PrefillPlan", "DecodePlan",
    "IdlePlan", "bucket_len", "record_token", "build_pool_cache",
    "check_supported", "pads_allowed", "slot_prefill", "slot_decode",
    "PagedLayout", "BlockAllocator",
]
