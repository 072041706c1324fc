"""Scheduler checkpoint/restore: exact continuation of in-flight serving
(DESIGN.md §14).

A checkpoint captures a *quiescent* ContinuousBatchingScheduler — the
state between ``run()`` calls, when no lagged step is in flight — as one
directory: ``pool.npz`` holds the device-resident pool state (cache
leaves — the paged arena, copied to the host —, position counters,
sampled-token frame) plus the host planning arrays, and ``sched.json``
holds the constructor recipe and the request lifecycle (in-flight slot
bindings, queued arrivals, planner budgets, request ids).
``restore_scheduler`` rebuilds the scheduler in a fresh process, with its
state on the restoring scheduler's device, and resumes decoding with
exactly the greedy tokens the donor process would have produced.

The files are the reference's (``core/persist/checkpoint.pack_arrays``
layout, bfloat16 as bit patterns), so a checkpoint either package wrote
restores in the other.  One entry differs by content: ``prefill_key`` is
the state of the port's prefill ``torch.Generator``, where the reference
keeps a jax PRNG key; a reference key seeds the port's generator from its
two words.  Greedy continuation is exact across the packages; sampled
continuation draws from each package's own RNG.

Model *parameters* are deliberately not persisted — the caller passes
them to ``restore`` just as to the constructor (they are checkpointed by
training, not by serving).  Timestamps are stored as ages relative to
the donor's clock and rebased onto the restoring clock, so latency
accounting stays monotone on the new clock.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.events import emit as ev
from repro_torch.core.persist.checkpoint import (pack_arrays, unpack_array,
                                                 unpack_tensor)
from repro_torch.serve.scheduler.telemetry import SCHED_DEFAULTS

FORMAT = 1


def _req_to_dict(req, now: float) -> dict:
    return {"prompt": [int(t) for t in np.asarray(req.prompt).ravel()],
            "max_new": int(req.max_new_tokens),
            "eos": int(req.eos_id),
            "rid": req.rid,
            "out": None if req.out_tokens is None
            else [int(t) for t in req.out_tokens],
            "done": bool(req.done),
            "age": max(0.0, now - (req.arrival_time or now)),
            "first_age": None if req.first_token_time is None
            else max(0.0, now - req.first_token_time)}


def _req_from_dict(d: dict, now: float):
    # serve.engine imports the scheduler package: import it at call time
    from repro_torch.serve.engine import Request
    req = Request(prompt=np.asarray(d["prompt"], np.int32),
                  max_new_tokens=int(d["max_new"]),
                  eos_id=int(d["eos"]),
                  arrival_time=now - float(d["age"]))
    req.rid = d["rid"]
    req.out_tokens = None if d["out"] is None else [int(t) for t in d["out"]]
    req.done = bool(d["done"])
    if d["first_age"] is not None:
        req.first_token_time = now - float(d["first_age"])
    return req


def _state_tensors(sch) -> dict:
    """Pool device state, path-independently ordered: cache leaves in
    registration order, then the position and token-frame rows."""
    if sch.use_terra:
        eng = sch._tf.engine
        svars = sch._cache_vars + [sch._pos_var, sch._tokf_var]
        return {f"s{i}": eng.variable_value(v) for i, v in enumerate(svars)}
    leaves = sch._cache_leaves + [sch._pos, sch._tokf]
    return {f"s{i}": x for i, x in enumerate(leaves)}


def _seed_generator(gen: torch.Generator, key: np.ndarray) -> None:
    """Restore the prefill generator: its own saved state, or a seed from
    the words of a reference checkpoint's PRNG key."""
    if key.dtype == np.uint8 and key.size == gen.get_state().numel():
        gen.set_state(torch.from_numpy(key.copy()))
        return
    seed = 0
    for w in key.ravel():
        seed = (seed * (1 << 32) + int(w)) % (1 << 63)
    gen.manual_seed(seed)


def save_scheduler(sch, path: str) -> None:
    """Write one checkpoint directory; requires a quiescent scheduler."""
    if sch._pending is not None:
        raise RuntimeError("checkpoint requires a quiescent scheduler "
                           "(call between run() invocations)")
    if sch.use_terra:
        sch._tf.wait()
    os.makedirs(path, exist_ok=True)
    now = sch.clock()
    arrays = _state_tensors(sch)
    arrays["prefill_key"] = sch._prefill_gen.get_state().numpy()
    arrays["pool_pos"] = np.asarray(sch.pool.pos)
    arrays["budget"] = np.asarray(sch.planner.budget)
    if sch.pool.block_table is not None:
        arrays["block_table"] = np.asarray(sch.pool.block_table)
    tmp = os.path.join(path, f"pool.tmp{os.getpid()}.npz")
    np.savez(tmp, **pack_arrays(arrays))
    os.replace(tmp, os.path.join(path, "pool.npz"))
    slots = [[s, _req_to_dict(r, now)] for s, r in sch.pool.active_items()]
    meta = {"fmt": FORMAT, "ctor": dict(sch._ckpt_kw),
            "rid": sch._rid, "submitted": sch.queue.submitted,
            "engine_iter_id": (sch._tf.engine.iter_id
                               if sch.use_terra else -1),
            "resident_tokens": sch.pool.resident_tokens,
            "peak_resident_tokens": sch.pool.peak_resident_tokens,
            "slots": slots,
            "queue": [_req_to_dict(r, now) for r in sch.queue._queue],
            "counters": {k: sch.sched_stats[k] for k in SCHED_DEFAULTS}}
    tmp = os.path.join(path, f"sched.json.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, "sched.json"))
    sch.sched_stats["checkpoint_saves"] = \
        sch.sched_stats.get("checkpoint_saves", 0) + 1
    ev.checkpoint_save(sch.events, path, vars_saved=len(arrays),
                       requests=len(slots) + len(meta["queue"]))


def restore_scheduler(cls, path: str, cfg, params, *,
                      clock=None, **overrides):
    """Rebuild a scheduler from ``save_scheduler`` output.  ``overrides``
    update the persisted constructor kwargs (e.g. a different
    ``steady_state``, or ``device``); shape-bearing ones must match the
    donor's."""
    with open(os.path.join(path, "sched.json")) as f:
        meta = json.load(f)
    if meta.get("fmt") != FORMAT:
        raise ValueError(f"unsupported scheduler checkpoint {path}")
    kw = dict(meta["ctor"])
    kw.update(overrides)
    if clock is not None:
        kw["clock"] = clock
    sch = cls(cfg, params, **kw)
    with np.load(os.path.join(path, "pool.npz")) as z:
        _restore_state(sch, z, meta, path)
    return sch


def _restore_state(sch, z, meta, path: str) -> None:
    now = sch.clock()
    n = sch._nc
    state = [unpack_tensor(z, f"s{i}").to(sch.device) for i in range(n + 2)]
    if sch.use_terra:
        eng = sch._tf.engine
        for var, buf in zip(sch._cache_vars + [sch._pos_var, sch._tokf_var],
                            state):
            eng.reset_variable(var, buf)
        eng.iter_id = int(meta["engine_iter_id"])
    else:
        sch._cache_leaves = state[:n]
        sch._pos, sch._tokf = state[n], state[n + 1]
    _seed_generator(sch._prefill_gen, unpack_array(z, "prefill_key"))
    pool = sch.pool
    pool.pos[:] = unpack_array(z, "pool_pos")
    if "block_table" in z.files and pool.block_table is not None:
        pool.block_table[:] = unpack_array(z, "block_table")
        used = {int(b) for b in pool.block_table.ravel() if b > 0}
        pool.allocator._free = [b for b in range(1, pool.allocator.num_blocks)
                                if b not in used]
    # dense pools count reserved rows too (row_tokens), so the resident
    # gauge restores on both layouts
    pool.resident_tokens = int(meta["resident_tokens"])
    pool.peak_resident_tokens = int(meta["peak_resident_tokens"])
    for slot, rd in meta["slots"]:
        req = _req_from_dict(rd, now)
        pool.requests[slot] = req
        pool._free.remove(slot)
    for rd in meta["queue"]:
        sch.queue._queue.append(_req_from_dict(rd, now))
    sch.queue.submitted = int(meta["submitted"])
    sch.planner.budget[:] = unpack_array(z, "budget")
    sch.planner.mark_dirty()
    sch._rid = int(meta["rid"])
    for k, v in meta["counters"].items():
        if k in SCHED_DEFAULTS:
            sch.sched_stats[k] = v
    sch.sched_stats["checkpoint_restores"] = \
        sch.sched_stats.get("checkpoint_restores", 0) + 1
    ev.checkpoint_restore(sch.events, path, vars_restored=n + 2,
                          requests=len(meta["slots"]) + len(meta["queue"]))
