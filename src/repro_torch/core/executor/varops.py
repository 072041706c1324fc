"""Fenced out-of-band variable updates (DESIGN.md §12).

``reset_variable`` is the pre-existing out-of-band write: it *fetches
nothing* but stalls the Python thread on the variable's use fence and
ships a host value.  Drivers that want to run device-resident work over
engine Variables *between* iterations — the serving scheduler's prefill
consuming and rewriting the KV-cache variables in place — need the
opposite: submit a closure into the engine's FIFO GraphRunner that reads
the current buffers, computes on device, and writes results back, fenced
exactly like a dispatched segment so iteration snapshots and later
readers order correctly behind it.  The Python thread never blocks and
no buffer crosses the host boundary.

Contract: the closure's writes must preserve each variable's aval (the
store's shape digest is not refreshed here; an aval change would demand
a family switch, which only ``reset_variable`` performs).  Requires a
closed iteration — the snapshot taken at the next ``start_iteration`` is
submitted FIFO-after this update, so divergence rollback semantics are
unchanged.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Callable, List, Sequence

from repro_torch.core.executor.coordinator import SKELETON
from repro_torch.core.tensor import Variable


def submit_variable_update(eng, reads: Sequence[Variable],
                           writes: Sequence[Variable],
                           fn: Callable, n_results: int = 0) -> List[Future]:
    """Queue ``fn(list_of_read_buffers) -> outputs`` on the GraphRunner.

    ``outputs[:len(writes)]`` become the new buffers of ``writes`` (same
    avals required); ``outputs[len(writes):]`` resolve the returned
    ``n_results`` futures.  Reads and writes are fenced, so this composes
    with in-flight dispatched segments and the next iteration's snapshot.
    """
    if eng._iter_open and eng.mode == SKELETON:
        raise RuntimeError("submit_variable_update inside an open "
                           "co-executed iteration")
    for var in tuple(reads) + tuple(writes):
        eng._ensure_var(var)
    store = eng.store
    read_ids = tuple(v.var_id for v in reads)
    write_ids = tuple(v.var_id for v in writes)
    futs = [Future() for _ in range(n_results)]

    def run():
        bufs = [store.read(i) for i in read_ids]
        try:
            outs = fn(bufs)
        except Exception as e:
            for f in futs:
                if not f.done():
                    f.set_exception(e)
            raise
        for vid, v in zip(write_ids, outs):
            store.buffers[vid] = v
        for f, v in zip(futs, outs[len(write_ids):]):
            f.set_result(v)

    seq = eng.runner.submit(run, "runner.varop")
    store.fence(read_ids, write_ids, seq)
    return futs
