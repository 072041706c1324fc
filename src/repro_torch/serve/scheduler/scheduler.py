"""ContinuousBatchingScheduler: the serving main loop under co-execution.

An ordinary imperative Python loop — arrival queue, slot pool, retirement,
streaming callbacks — run as the skeleton of a ``terra.function`` whose
one DL op is the masked ``slot_decode`` step (pool_ops.py).  Pool state
lives as framework Variables threading GraphRunner-to-GraphRunner on
device; the loop runs one step deep (dispatch N+1, then harvest N);
admission prefills splice device buffers through fenced closures
(varops).  ``page_size`` selects the paged arena (paged.py);
``use_terra=False`` is the plain-PyTorch scheduling baseline (op bodies
called directly, pool donated, a CUDA graph per step shape on a card).
``device`` (default: the CUDA card) holds the params, the pool and every
step.  ``checkpoint``/``restore`` persist a quiescent scheduler (the paged
arena copied to the host); ``profile``, ``set_profile`` and
``enable_metrics`` drive repro_torch.obs.  See DESIGN.md §11-§12, §14-§15."""

from __future__ import annotations

import os
import time
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import function as terra_function
from repro_torch.core import ops as ops_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.executor import SKELETON, steady, varops
from repro_torch.core.ops import op_impl
from repro_torch.core.pytree import tree_flatten
from repro_torch.core.tensor import TerraTensor, Variable
from repro_torch.core.trace import as_tensor, to_numpy
from repro_torch.serve.scheduler import checkpoint as ckpt
from repro_torch.serve.scheduler import pool_ops
from repro_torch.serve.scheduler import telemetry as tm
from repro_torch.serve.scheduler.lifecycle import (ArrivalQueue, CallbackQueue,
                                             deliver)
from repro_torch.serve.scheduler.paged import PagedLayout
from repro_torch.serve.scheduler.planner import (DecodePlan, IdlePlan,
                                           PrefillPlan, StepPlanner)
from repro_torch.serve.scheduler.slots import SlotPool


class ContinuousBatchingScheduler:
    """Slot-pooled continuous-batching serving engine (DESIGN.md §11/§12)."""

    def __init__(self, cfg, params, *, max_slots: int = 8,
                 max_len: int = 256, temperature: float = 0.0,
                 use_terra: bool = True, optimize: Optional[str] = None,
                 prefill_batch_cap: Optional[int] = None,
                 bucket_floor: int = 8, page_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 steady_state: int = 8, steady_probe: int = 128,
                 profile: int = 0,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        pool_ops.check_supported(cfg)
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.temperature = temperature
        self.use_terra = use_terra
        self.clock = clock
        self._has_rng = temperature > 0.0
        self._prefill_gen = torch.Generator().manual_seed(0)
        self.layout = None
        if page_size:
            if num_blocks is None:      # dense-equivalent arena + trash
                num_blocks = (max_slots * max_len) // page_size + 1
            self.layout = PagedLayout(page_size, num_blocks, max_len)
        ps = self.layout.block_size if self.layout else 0
        nb = self.layout.num_blocks if self.layout else 0

        leaves0, cache_def, axes, paged = pool_ops.build_pool_cache(
            cfg, max_slots, max_len, ps, nb, device=dev)
        params_leaves, params_def = tree_flatten(params)
        # params already on the device are used as they are (no copy)
        self._params_leaves = [as_tensor(l, dev) for l in params_leaves]
        self._np, self._nc = len(self._params_leaves), len(leaves0)
        self._mid = pool_ops.register_pool_meta(
            cfg, params_def, cache_def, axes, temperature, max_len,
            ps, nb, paged)
        self._attrs = dict(_meta=self._mid, _n_params=self._np,
                           _n_cache=self._nc, _has_rng=self._has_rng)
        pos0 = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        tokf0 = torch.zeros((max_slots, 1), dtype=torch.int32, device=dev)

        if use_terra:
            # SAFE default: mask/block-table feeds never constant-fold (§10)
            if optimize is None:
                optimize = os.environ.get("TERRA_OPTIMIZE") or "safe"
            self._param_vars = [Variable(l, name=f"sched.p{i}")
                                for i, l in enumerate(self._params_leaves)]
            self._cache_vars = [Variable(l, name=f"sched.c{i}")
                                for i, l in enumerate(leaves0)]
            self._pos_var = Variable(pos0, name="sched.pos")
            self._tokf_var = Variable(tokf0, name="sched.tokf")
            self._tf = terra_function(self._step, optimize=optimize,
                                      steady_state=steady_state,
                                      steady_probe=steady_probe,
                                      profile=profile, device=dev)
            self._prefill_fn = op_impl("serve.slot_prefill")
        else:
            self._cache_leaves = list(leaves0)
            self._pos, self._tokf = pos0, tokf0
            self._decode_fn, self._prefill_fn, self._capture = \
                pool_ops.baseline_steps(self._np, self._nc, self._attrs, dev)

        self.pool = SlotPool(max_slots, self.layout, row_tokens=max_len)
        self.queue = ArrivalQueue(clock)
        self.callbacks = CallbackQueue()
        self.planner = StepPlanner(cfg, self.queue, self.pool, max_len,
                                   prefill_batch_cap or max_slots,
                                   bucket_floor)
        self._pending = None            # the one in-flight (lagged) step
        self._step_no = 0               # loop passes, the spans' ``step``
        # one instrumentation substrate (§13): share the engine's stream
        self.events = tm.make_stream(
            self._tf.engine.events if use_terra else None, clock)
        self.sched_stats = self.events.counters
        if not use_terra and self._capture is not None:
            self._capture.events = self.events      # its spans (§15)
        self._rid = 0
        self._ckpt_kw = dict(       # the recipe checkpoint() persists
            max_slots=max_slots, max_len=max_len, temperature=temperature,
            use_terra=use_terra, optimize=optimize,
            prefill_batch_cap=prefill_batch_cap, bucket_floor=bucket_floor,
            page_size=ps or None, num_blocks=nb or None, profile=profile,
            steady_state=steady_state, steady_probe=steady_probe)

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def submit(self, request) -> None:
        L = len(request.prompt)
        if L < 1:
            raise ValueError("empty prompt")
        if L + request.max_new_tokens + 1 > self.max_len:
            raise ValueError(
                f"prompt ({L}) + max_new_tokens ({request.max_new_tokens})"
                f" exceeds pool max_len {self.max_len}")
        if self.layout is not None:
            need = self.layout.blocks_needed(L, request.max_new_tokens)
            if need > self.pool.allocator.capacity:
                raise ValueError(
                    f"request needs {need} blocks; arena capacity is "
                    f"{self.pool.allocator.capacity}")
        self._rid += 1
        tm.request_submit(self.events, request, self._rid)
        self.queue.submit(request)

    def serve(self, requests: List[object]) -> List[object]:
        """Convenience: submit a batch and run until drained."""
        for r in requests:
            self.submit(r)
        self.run()
        return requests

    def run(self, max_steps: Optional[int] = None) -> None:
        """Serve until drained, one step deep: dispatch the next step,
        *then* harvest the previous step's token frame."""
        steps, es = 0, self.events
        while (len(self.queue) or self.pool.active_count
               or self._pending is not None):
            self._step_no += 1
            with es.span("sched.step", step=self._step_no):
                with es.span("sched.plan", step=self._step_no):
                    plan = self.planner.next_plan(self.clock())
                if isinstance(plan, PrefillPlan):
                    nxt = self._dispatch_prefill(plan)
                elif isinstance(plan, DecodePlan):
                    nxt = self._dispatch_decode(plan)
                else:
                    nxt = None
                prev, self._pending = self._pending, nxt
                if prev is not None:
                    self._harvest(prev)
                    with es.span("sched.deliver", step=prev[3]):
                        self.callbacks.flush()
                elif nxt is None:
                    self._idle(plan)
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        if self._pending is not None:
            self._harvest(self._pending)
            self._pending = None
        with es.span("sched.deliver"):
            self.callbacks.flush()
        if self.use_terra:
            self._tf.wait()

    @property
    def stats(self) -> dict:
        return tm.merged_stats(self)

    def set_profile(self, every: int) -> None:
        """Runtime-mutable sampled profiling cadence (DESIGN.md §15)."""
        tm.set_profile(self, every)

    def enable_metrics(self, registry=None):
        """Attach a live metrics processor; returns its registry (§15)."""
        return tm.enable_metrics(self, registry)

    def checkpoint(self, path: str) -> None:
        """Persist quiescent state for cross-process continuation (§14)."""
        ckpt.save_scheduler(self, path)

    @classmethod
    def restore(cls, path: str, cfg, params, **overrides):
        """Rebuild a checkpointed scheduler: decoding resumes exactly."""
        return ckpt.restore_scheduler(cls, path, cfg, params, **overrides)

    def close(self) -> None:
        if self.use_terra:
            self._tf.close()
        elif self._capture is not None:
            self._capture.release()

    # ------------------------------------------------------------------
    # step execution
    # ------------------------------------------------------------------
    def _step(self, mask, bt=None):
        """The co-executed skeleton step: one masked slot_decode node."""
        args = [v.read() for v in self._param_vars]
        args += [v.read() for v in self._cache_vars]
        args += [self._pos_var.read(), self._tokf_var.read(), mask]
        if bt is not None:
            args.append(bt)
        if self._has_rng:
            args.append(ops_mod._next_key())   # iteration-stable key feed
        outs = pool_ops.slot_decode(*args, **self._attrs)
        tok, leaves = outs[0], outs[1:-2]
        for var, leaf in zip(self._cache_vars, leaves):
            var.assign(leaf)
        self._pos_var.assign(outs[-2])
        self._tokf_var.assign(outs[-1])
        return tok

    def _dispatch_decode(self, plan: DecodePlan):
        with self.events.span("sched.dispatch.decode",
                              step=self._step_no) as sp:
            t0 = time.perf_counter()
            if self.use_terra:
                tok = (self._tf(plan.mask) if plan.bt is None
                       else self._tf(plan.mask, plan.bt))
                if isinstance(tok, TerraTensor):
                    if self._tf.engine.mode != SKELETON:
                        # warmup: fetch now so the trace records the fetch
                        # point (§4.2) the lagged harvest relies on
                        tok = np.asarray(tok)
                    elif tok._eager is None and tok._future is None:
                        tok = np.asarray(tok)   # mid-replay: fetch, not stale
            else:
                dev = self.device
                args = self._params_leaves + self._cache_leaves
                args += [self._pos, self._tokf, as_tensor(plan.mask, dev)]
                if plan.bt is not None:
                    args.append(as_tensor(plan.bt, dev))
                if self._has_rng:
                    args.append(as_tensor(self._next_key(), dev))
                outs = self._decode_fn(*args)
                tok, self._pos, self._tokf = outs[0], outs[-2], outs[-1]
                self._cache_leaves = list(outs[1:-2])
            pairs = [(s, r) for s, r in self.pool.active_items()
                     if plan.mask[s]]
            if sp:
                sp.ids.update(rows=len(pairs), rids=[r.rid for _, r in pairs])
            self.pool.advance_active(plan.mask)
            self.planner.consume(plan.mask)
            self.sched_stats["decode_steps"] += 1
            tm.step_done(self, "decode", int(plan.mask.sum()), t0)
            return ("decode", tok, pairs, self._step_no)

    def _dispatch_prefill(self, plan: PrefillPlan):
        with self.events.span("sched.dispatch.prefill",
                              step=self._step_no) as sp:
            t0 = time.perf_counter()
            ntok = tm.prefill_admitted(self, plan, sp)
            dev = self.device
            key = as_tensor(self._next_key(), dev) if self._has_rng else None
            frames = [as_tensor(plan.tokens, dev), as_tensor(plan.slots, dev),
                      as_tensor(plan.lengths, dev)]
            if plan.bt_rows is not None:
                frames.append(as_tensor(plan.bt_rows, dev))
            if not self.use_terra:
                args = self._params_leaves + self._cache_leaves
                args += [self._pos, self._tokf] + frames
                if key is not None:
                    args.append(key)
                with tm.prefill_span(self.events, plan, ntok):
                    outs = self._prefill_fn(*args)
                tok, self._pos, self._tokf = outs[0], outs[-2], outs[-1]
                self._cache_leaves = list(outs[1:-2])
                tm.step_done(self, "prefill", len(plan.requests), t0)
                return ("prefill", tok, plan, self._step_no)
            eng = self._tf.engine
            state_vars = self._cache_vars + [self._pos_var, self._tokf_var]
            if eng.mode != SKELETON:
                # warmup (tracing) path: ops still run on the Python thread,
                # so the out-of-band rebind (§8) is the correct splice
                bufs = self._params_leaves + [eng.variable_value(v)
                                              for v in state_vars]
                bufs += frames + ([key] if key is not None else [])
                with tm.prefill_span(self.events, plan, ntok):
                    outs = self._prefill_fn(*bufs, **self._attrs)
                leaves = list(outs[1:-2]) + [outs[-2], outs[-1]]
                for var, leaf in zip(state_vars, leaves):
                    eng.reset_variable(var, leaf)
                tok = to_numpy(outs[0])
            else:
                # co-execution: consume the pool Variables' device buffers
                # through a fenced GraphRunner closure (§12); no stall.  No
                # snapshot holds a pool a live steady plan owns: write in place
                op = ops_mod.OPS["serve.slot_prefill"]
                pfn = op.inplace if all(steady.donates(eng, v.var_id)
                                        for v in state_vars) else op.impl
                attrs, es = self._attrs, self.events

                def splice(bufs):
                    args = bufs + frames
                    if key is not None:
                        args.append(key)
                    with tm.prefill_span(es, plan, ntok):
                        outs = pfn(*args, **attrs)
                    return tuple(outs[1:-2]) + (outs[-2], outs[-1], outs[0])

                tok = varops.submit_variable_update(
                    eng, self._param_vars + state_vars, state_vars,
                    splice, n_results=1)[0]
            tm.step_done(self, "prefill", len(plan.requests), t0)
            return ("prefill", tok, plan, self._step_no)

    # ------------------------------------------------------------------
    # harvest + delivery (one step behind dispatch)
    # ------------------------------------------------------------------
    def _harvest(self, entry) -> None:
        kind, payload, extra, step = entry
        es = self.events
        with es.span("sched.fetch", step=step):
            t0 = time.perf_counter()
            toks = to_numpy(payload.result()) \
                if isinstance(payload, Future) else to_numpy(payload)
            tm.harvest_done(self, kind, t0)
        with es.span("sched.deliver", step=step):
            deliver(self, kind, toks, extra, self.clock())

    def _idle(self, plan: IdlePlan) -> None:
        with self.events.span("sched.idle", step=self._step_no):
            self.callbacks.flush()
            self.sched_stats["idle_waits"] += 1
            tm.idle(self.events, plan.wait)
            if plan.wait and plan.wait > 0:
                # the stream owns the clock semantics (real sleep vs. yield)
                self.events.sleep(min(plan.wait, 0.02))

    def _next_key(self):
        return ops_mod.draw_key(self._prefill_gen)
