"""Divergence fallback: cancel the GraphRunner, replay the validated prefix.

Paper §4.1: when validation fails (the program followed a trace the
TraceGraph does not cover), Terra (1) cancels the symbolic work of the
current iteration — drain the GraphRunner and restore the variable store
from the iteration-start snapshot — then (2) *replays* the already-validated
prefix of DL ops eagerly to rematerialize every live placeholder tensor, and
(3) finishes the iteration imperatively.  Python side effects are never
re-executed: only the recorded DL ops run again, against the recorded feed
values and the restored variable buffers.

The prefix is replayed exactly once per divergence (asserted by
tests/test_executor.py via ``stats["replayed_entries"]``).
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core import ops as ops_mod
from repro_torch.core.events import emit as ev
from repro_torch.core.ops import Const
from repro_torch.core.trace import FeedRef, Ref, Trace, VarRef


class DivergenceHandler:
    """Owns cancel + replay; stateless across iterations."""

    def __init__(self, runner, store, events):
        self.runner = runner
        self.store = store
        self.events = events
        self.stats = events.counters

    def cancel_and_replay(self, trace: Trace, feed_log: Dict,
                          snapshot: Dict[int, Any], vals: Dict,
                          tensors: Dict, iter_id: int = -1) -> None:
        """Drain pending graph work, roll back variables, replay the prefix.

        ``vals`` is refilled with every replayed output and ``tensors``'
        live placeholders get their ``_eager`` slots filled in place, after
        which the iteration can continue imperatively.  The Rollback and
        Replay events carry ``iter_id`` so the trace links them causally to
        the Divergence the coordinator emitted (DESIGN.md §13).
        """
        self.stats["replays"] += 1
        self.stats["transitions"] += 1
        # cancel the iteration atomically: drain pending closures, close
        # the iteration window, and discard any stashed closure error (the
        # cancelled iteration's effects are rolled back, so its errors are
        # moot) — one public call, no reaching into runner internals
        self.runner.cancel()
        # cancel this iteration's effects: restore the variable snapshot
        # UNCONDITIONALLY.  An empty snapshot is a real pre-iteration
        # state (the store held no buffers), not a missing one — skipping
        # the restore would leak buffers first written by the cancelled
        # iteration (e.g. a Variable created inside it).
        self.store.restore(snapshot)
        ev.rollback(self.events, iter_id, len(snapshot))
        # eager replay of the validated prefix (DL ops only — Python side
        # effects are NOT re-run)
        vals.clear()
        store = self.store
        for ordinal, entry in enumerate(trace.entries):
            ins = []
            for pos, r in enumerate(entry.input_refs):
                if isinstance(r, Ref):
                    ins.append(vals[(r.entry, r.out_idx)])
                elif isinstance(r, FeedRef):
                    ins.append(store.stage(feed_log[(ordinal, pos)]))
                elif isinstance(r, VarRef):
                    # read_initial: the rollback may have removed the seed
                    # buffer of a variable first registered this iteration
                    ins.append(store.read_initial(r.var_id))
                elif isinstance(r, Const):
                    ins.append(r.value)
            out = ops_mod.OPS[entry.op_name].impl(*ins, **dict(entry.attrs))
            outs = out if isinstance(out, tuple) else (out,)
            for oi, v in enumerate(outs):
                vals[(ordinal, oi)] = v
                t = tensors.get((ordinal, oi))
                if t is not None:
                    t._eager = v
        self.stats["replayed_entries"] += len(trace.entries)
        ev.replay(self.events, iter_id, len(trace.entries))
