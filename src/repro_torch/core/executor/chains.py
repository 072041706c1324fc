"""Path-specialized chain dispatch (DESIGN.md §2).

A gating fetch that is *not* at a top-level segment boundary (e.g. inside a
branch region) cannot cut a segment soundly.  Instead of replaying eagerly,
the coordinator swaps in a :class:`ChainDispatcher`: the exact linear chain
of already-validated ops becomes one callable — selectors are resolved by
construction, so no switch machinery is needed — and every produced value
gets a future.  Chains are cached by their op/src structure in an
engine-lifetime cache, shared across TraceGraph families: on the CPU a
chain callable runs eagerly on whatever shapes it is given, and on a CUDA
card it is a :class:`~repro_torch.core.capture.CapturedFn`, whose graph
key carries the input shapes, so sibling shape classes share the callable
and get a graph each.

Split out of dispatch.py, which keeps the Dispatcher protocol and the
segment dispatcher; ``repro_torch.core.executor.dispatch`` re-exports
ChainDispatcher so historical import paths keep working.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import ops as ops_mod
from repro_torch.core.device import SegmentTimer
from repro_torch.core.events import emit as ev
from repro_torch.core.trace import FeedRef, Ref, VarRef
from repro_torch.core.executor.dispatch import Dispatcher, SegmentDispatcher
from repro_torch.core.executor.walker import ReplayRequired

class ChainDispatcher(Dispatcher):
    kind = "chain"

    def __init__(self, parent: SegmentDispatcher, feed_log: Dict,
                 chain_cache: Dict[Tuple, Any]):
        self.parent = parent
        self.walker = parent.walker
        self.tg = parent.gp.tg
        self.trace = parent.trace
        self.runner = parent.runner
        self.store = parent.store
        self.events = parent.events
        self.stats = parent.stats
        self.iter_id = parent.iter_id
        self.feed_log = feed_log
        self.chain_cache = chain_cache          # engine-lifetime chain cache
        self.chain_env: Dict[Tuple[int, int], Any] = {}
        self.futures: Dict[Tuple[int, int], Future] = {}
        # the chain picks up after whatever segments already dispatched
        self.start = parent.ordinal_at_dispatch

    # ------------------------------------------------------------------
    def on_boundary(self, seg_idx: int) -> None:
        pass        # chains ignore segment boundaries

    def finish(self) -> None:
        self.flush()                            # trailing chain (side effects)

    def future_for(self, ref: Ref) -> Optional[Future]:
        fut = self.futures.get((ref.entry, ref.out_idx))
        if fut is not None:
            return fut
        try:
            return self.parent.future_for(ref)  # dispatched-segment values
        except ReplayRequired:
            return None

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Build (or reuse) + submit the chain of ops recorded since the
        last flush."""
        start, end = self.start, len(self.trace.entries)
        if end <= start:
            return
        entries = self.trace.entries[start:end]

        key_parts = []
        ext_plan: List[Tuple] = []   # ('chain', e, oi) | ('seg', uid, oi)
        ext_index: Dict[Tuple, int] = {}
        feeds = []
        var_ids: List[int] = []
        var_index: Dict[int, int] = {}
        arg_plans = []
        for local, e in enumerate(entries):
            plan = []
            for pos, r in enumerate(e.input_refs):
                if isinstance(r, Ref) and r.entry >= start:
                    plan.append(("i", r.entry - start, r.out_idx))
                elif isinstance(r, Ref):
                    k = ("r", r.entry, r.out_idx)
                    if k not in ext_index:
                        ext_index[k] = len(ext_plan)
                        uid = self.walker.ord_to_uid.get(r.entry)
                        # values produced by an earlier chain flush are keyed
                        # by futures (updated synchronously on this thread);
                        # chain_env is runner-thread state and may lag
                        if (r.entry, r.out_idx) in self.futures or uid is None:
                            ext_plan.append(("chain", r.entry, r.out_idx))
                        else:
                            n = self.tg.nodes[uid]
                            oi = (n.body.out_slot_for(r, ())
                                  if n.kind == "loop" else r.out_idx)
                            key = (uid, oi)
                            if key in self.parent.fetch_futures:
                                # a fetched-but-not-carried value: read it
                                # off the completed segment future (FIFO ⇒
                                # the producer ran before this closure)
                                ext_plan.append(("fetch", uid, oi))
                            elif key in self.parent.gp.published:
                                ext_plan.append(("seg", uid, oi))
                            else:
                                # the optimized segments no longer publish
                                # this value (e.g. its node was DCE'd);
                                # the caller recovers via eager replay
                                raise ReplayRequired()
                    plan.append(("x", ext_index[k]))
                elif isinstance(r, FeedRef):
                    plan.append(("f", len(feeds)))
                    feeds.append(self.store.stage(
                        self.feed_log[(start + local, pos)]))
                elif isinstance(r, VarRef):
                    if r.var_id not in var_index:
                        var_index[r.var_id] = len(var_ids)
                        var_ids.append(r.var_id)
                    plan.append(("v", var_index[r.var_id]))
                else:
                    plan.append(("c", r.value))
            arg_plans.append(tuple(plan))
            key_parts.append((e.op_name, e.attrs, e.location,
                              tuple((p[0],) + tuple(p[1:]) for p in plan)))
        capture = self.parent.gp.capture
        key = (start == 0, capture is not None, tuple(key_parts))

        fn = self.chain_cache.get(key)
        if fn is None:
            fn = _build_chain_fn(entries, arg_plans, capture)
            self.chain_cache[key] = fn

        # futures for every produced value
        produced = []
        futures = {}
        for j, e in enumerate(entries):
            for oi in range(len(e.out_avals)):
                futures[(start + j, oi)] = Future()
                produced.append((start + j, oi))
        self.futures.update(futures)

        assigns = {vid: ref for vid, ref in self.trace.var_assigns.items()
                   if isinstance(ref, Ref) and start <= ref.entry < end}
        buffers = self.store.buffers
        iter_env = self.parent.iter_env
        chain_env = self.chain_env

        fetch_futures = self.parent.fetch_futures

        def run(fn=fn, var_ids=tuple(var_ids), feeds=tuple(feeds),
                ext_plan=tuple(ext_plan), futures=futures, assigns=assigns,
                produced=tuple(produced), start=start,
                profile=self.parent.profile):
            var_vals = tuple(buffers[v] for v in var_ids)
            exts = tuple(
                chain_env[(p[1], p[2])] if p[0] == "chain"
                else fetch_futures[(p[1], p[2])].result() if p[0] == "fetch"
                else iter_env[(p[1], p[2])] for p in ext_plan)
            if profile:
                timer = SegmentTimer(self.store.device)
            try:
                outs = fn(var_vals, feeds, exts)
            except Exception as exc:        # noqa: BLE001
                for f in futures.values():
                    if not f.done():
                        f.set_exception(exc)
                raise
            if profile:
                # sampled device-time attribution (DESIGN.md §15); the
                # chain index is its trace-ordinal start, matching the
                # SegmentDispatch "chain" event
                ev.segment_profile(self.events, self.iter_id, "chain",
                                   start, *timer.stop())
            for (ordv, v) in zip(produced, outs):
                chain_env[ordv] = v
                futures[ordv].set_result(v)
            for vid, ref in assigns.items():
                buffers[vid] = chain_env[(ref.entry, ref.out_idx)]

        seq = self.runner.submit(run, "runner.chain")
        self.store.fence(var_ids, assigns, seq)
        self.stats["segments_dispatched"] += 1
        ev.segment_dispatch(self.events, self.iter_id, "chain", start, seq,
                            len(feeds))
        self.start = end


def _build_chain_fn(entries, arg_plans, capture=None):
    """The linear op chain as one callable: (var_vals, feed_vals,
    ext_vals) -> flat outs, without autograd; captured through the
    engine's CaptureContext on a CUDA card (every out escapes to a future
    or the store, so every out is copied out of the graph)."""
    impls = [ops_mod.OPS[e.op_name].impl for e in entries]
    attrs = [dict(e.attrs) for e in entries]
    plans = list(arg_plans)

    @torch.no_grad()
    def chain_fn(var_vals, feed_vals, ext_vals):
        env: Dict[Tuple[int, int], Any] = {}
        flat_out = []
        for j, impl in enumerate(impls):
            vals = []
            for p in plans[j]:
                if p[0] == "i":
                    vals.append(env[(p[1], p[2])])
                elif p[0] == "x":
                    vals.append(ext_vals[p[1]])
                elif p[0] == "f":
                    vals.append(feed_vals[p[1]])
                elif p[0] == "v":
                    vals.append(var_vals[p[1]])
                else:
                    vals.append(p[1])
            out = impl(*vals, **attrs[j])
            outs = out if isinstance(out, tuple) else (out,)
            for oi, v in enumerate(outs):
                env[(j, oi)] = v
            flat_out.extend(outs)
        return tuple(flat_out)

    if capture is None:
        return chain_fn
    if not all(ops_mod.OPS[e.op_name].capturable for e in entries):
        return capture.eager(chain_fn)
    return capture.wrap(chain_fn)
