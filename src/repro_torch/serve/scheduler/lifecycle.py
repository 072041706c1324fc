"""Request lifecycle: arrivals, admission grouping, retirement, streaming.

This is deliberately plain imperative Python — timestamped queues,
per-request counters, third-party streaming callbacks — i.e. the program
class the paper argues must keep running under the Python interpreter
(coverage argument, PAPER.md): none of it is expressible inside the
symbolic graph, and none of it needs to be, because only the sampled
tokens cross the fetch boundary each step.

Streaming callbacks are the repo's third-party-code stand-in: the
scheduler queues them as tokens are fetched and flushes the queue right
*after* dispatching the next decode step, so user callback time overlaps
queued device work (PR-2 per-value fences) instead of stalling the loop.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from repro_torch.core.executor.families import bucket_pow2
from repro_torch.serve.scheduler import telemetry as tm
from repro_torch.serve.scheduler.pool_ops import pads_allowed


def bucket_len(cfg, length: int, max_len: int, floor: int = 8) -> int:
    """Length bucket a prompt prefills at.  Attention-only stacks pad to
    the next power-of-two cell (bounding prefill compile variants to
    O(log max_len)); recurrent stacks fold *every* position into their
    state, so padding would corrupt it — they prefill at exact length,
    but for those whose prefill masks each row at its length
    (``pool_ops.MASKED_KINDS``), which pad as attention stacks do."""
    if not pads_allowed(cfg):
        return length
    return min(bucket_pow2(length, floor), max_len)


class ArrivalQueue:
    """Timestamped FIFO of submitted requests (arrival order preserved)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._queue: List[object] = []
        self.submitted = 0

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, request) -> None:
        if request.arrival_time is None:
            request.arrival_time = self.clock()
        # re-submission starts a fresh lifecycle: stale timestamps would
        # otherwise survive record_token's stamp-once guards
        request.out_tokens = None
        request.done = False
        request.first_token_time = None
        request.finish_time = None
        self._queue.append(request)
        self.submitted += 1

    def next_arrival(self) -> Optional[float]:
        return min((r.arrival_time for r in self._queue), default=None)

    def pop_admission(self, now: float, free_slots: int, cfg, max_len: int,
                      batch_cap: int, bucket_floor: int = 8, fits=None):
        """One admission group: the earliest-arrived admissible request
        fixes the length bucket; every other admissible request of the
        same bucket joins, in arrival order, up to min(free slots,
        batch_cap).  Returns (bucket, [requests]) or None.

        ``fits`` (paged pools, SlotPool.admit_checker) is a stateful
        capacity predicate.  A head-of-line request that does not fit
        blocks the whole admission — FIFO is preserved, backpressure is
        queue-and-wait; a later group member that does not fit is merely
        skipped (it would strand capacity the head already reserved)."""
        limit = min(free_slots, batch_cap)
        if limit <= 0:
            return None
        ready = sorted((r for r in self._queue if r.arrival_time <= now),
                       key=lambda r: r.arrival_time)
        if not ready:
            return None
        if fits is not None and not fits(ready[0]):
            return None
        bucket = bucket_len(cfg, len(ready[0].prompt), max_len,
                            bucket_floor)
        group: List[object] = []
        for r in ready:
            if len(group) >= limit:
                break
            if bucket_len(cfg, len(r.prompt), max_len,
                          bucket_floor) != bucket:
                continue
            if group and fits is not None and not fits(r):
                continue
            group.append(r)
        taken = {id(r) for r in group}
        self._queue = [r for r in self._queue if id(r) not in taken]
        return bucket, group


# --------------------------------------------------------------------------
# Retirement + streaming
# --------------------------------------------------------------------------

def record_token(request, token: int, now: float) -> bool:
    """Append one generated token; returns True when the request is
    finished (EOS or token budget) and should release its slot.  Mirrors
    the lock-step engine's retirement rule exactly (token-equality is a
    bench gate)."""
    if request.out_tokens is None:
        request.out_tokens = []
        request.first_token_time = now
    request.out_tokens.append(int(token))
    if int(token) == request.eos_id:
        request.done = True
    finished = request.done or len(request.out_tokens) >= \
        request.max_new_tokens
    if finished and request.finish_time is None:
        request.finish_time = now
    return finished


def deliver(sch, kind: str, toks, extra, now: float) -> None:
    """Hand one harvested token frame (``toks``, [rows, 1]) to the
    requests of the step that made it: ``extra`` is a decode step's
    (slot, request) pairs or a prefill step's plan.  Each token is
    recorded and its streaming callback queued; a finished request
    retires and frees its slot."""
    if kind == "decode":
        for slot, req in extra:
            # a request retired by an earlier harvest may have been
            # dispatched one garbage step (lag): never deliver it
            if req.done or sch.pool.requests[slot] is not req:
                continue
            _deliver_one(sch, req, int(toks[slot, 0]), slot, now)
    else:
        for i, req in enumerate(extra.requests):
            _deliver_one(sch, req, int(toks[i, 0]), int(extra.slots[i]),
                         now)


def _deliver_one(sch, req, token: int, slot: int, now: float) -> None:
    finished = record_token(req, token, now)
    sch.sched_stats["generated_tokens"] += 1
    tm.request_token(sch.events, req, token)
    sch.callbacks.push(req, token)
    if finished:
        sch.pool.release(slot)
        sch.sched_stats["retired"] += 1
        tm.request_retire(sch.events, req)
        sch.planner.mark_dirty()


class CallbackQueue:
    """Deferred per-token streaming callbacks.

    ``push`` is called as tokens come off the fetch boundary; ``flush``
    runs the queued callbacks — the scheduler flushes *after* submitting
    the next step, so arbitrary third-party callback code executes while
    the GraphRunner works.  Callback exceptions propagate to the caller
    of flush (user code failing is a user error, not a scheduler state)."""

    def __init__(self):
        self._queue: List[Tuple[Callable, object, int, int]] = []
        self.delivered = 0

    def __len__(self) -> int:
        return len(self._queue)

    def push(self, request, token: int) -> None:
        if request.stream is not None:
            idx = len(request.out_tokens) - 1
            self._queue.append((request.stream, request, token, idx))

    def flush(self) -> None:
        queued, self._queue = self._queue, []
        try:
            while queued:
                cb, req, tok, idx = queued.pop(0)
                cb(req, tok, idx)
                self.delivered += 1
        finally:
            # a raising callback loses only its own delivery: everything
            # still queued (other requests' tokens) goes back in front
            self._queue[:0] = queued
