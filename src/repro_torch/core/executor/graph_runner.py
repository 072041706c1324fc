"""GraphRunner: the ordered asynchronous executor thread (paper §4.1).

The GraphRunner drains a FIFO of dispatch closures on a dedicated thread so
the PythonRunner (the user's Python thread executing the skeleton program)
never blocks on graph execution except at explicit Output Fetching points.
Closures are opaque here — segment dispatch, chain dispatch and variable
snapshots are all just queued work — which keeps this module free of any
TraceGraph/GraphProgram knowledge.

Because the queue is strictly FIFO, completion is a *monotone sequence
number*: ``submit`` returns the closure's 1-based sequence index, and a
consumer that needs closure *n*'s effects waits with ``wait_for(n)``.  The
per-variable readiness fences (variables.py, DESIGN.md §4.4) are just these
integers — no per-closure Future objects, and a single condition variable
covers enqueue, completion and drain.

In ``lazy`` mode (the Table-2 LazyTensor-style ablation) no thread is
started; queued work is executed on the *calling* thread by
``run_pending_now()`` the moment a fetch needs it, which serializes Python
and graph execution exactly like a lazy-evaluation runtime.

Dispatch closures do not block until device results are ready (no
per-segment synchronize barrier): device execution stays async on the
device's default stream behind the fetch futures, and blocking happens only
when a future's value is actually converted/read on the Python side.  All
work stays on that one stream, which torch shares across threads, so the
runner thread's kernels are ordered after the Python thread's without
events.  ``exec_time`` therefore measures
enqueue-to-enqueue runner occupancy, and wall-clock device sync is visible
only in ``py_stall_time`` at fetch points (see DESIGN.md §4).

Each closure runs inside a span named by its submitter (``runner.segment``,
``runner.chain``, ``runner.steady``, ``runner.varop``,
``runner.snapshot``) carrying its sequence number, on the runner's thread
(DESIGN.md §15).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from repro_torch.core.events import types as _T
from repro_torch.core.events.spans import NO_SPAN


class GraphRunner:
    """FIFO executor with stall accounting, threaded unless ``lazy``."""

    def __init__(self, lazy: bool = False, events=None):
        self.lazy = lazy
        # optional EventStream: completion events (seq + wall/stall) are
        # emitted from the runner thread; the stream serializes delivery
        self.events = events
        self._dq: deque = deque()
        self._cv = threading.Condition()
        self._submitted = 0
        self._completed = 0
        self.exec_time = 0.0
        self.stall_time = 0.0
        self._last_done = time.perf_counter()
        self._open = False                     # an iteration is in flight
        # first closure exception since the last sync/cancellation: the
        # worker thread survives (a dead thread would hang every later
        # fence wait and drain), errors reach fetchers through their
        # futures, and engine.sync() re-raises this for fetchless failures
        self.pending_error = None
        if not lazy:
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="terra-graphrunner")
            self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, closure, span: str) -> int:
        """Enqueue; returns the closure's 1-based completion sequence.
        ``span`` names the span the closure runs in."""
        with self._cv:
            self._dq.append((closure, span))
            self._submitted += 1
            seq = self._submitted
            self._cv.notify()
        return seq

    def done(self, seq: int) -> bool:
        """True once the seq-th submitted closure has finished (lock-free:
        a stale read only under-reports, which at worst waits once more)."""
        return self._completed >= seq

    def _run_one(self, closure, span: str):
        t0 = time.perf_counter()
        stalled = max(0.0, t0 - self._last_done) if self._open else 0.0
        self.stall_time += stalled
        es = self.events
        err = None
        try:
            # FIFO: the closure running is the next one to complete
            with (es.span(span, seq=self._completed + 1) if es is not None
                  else NO_SPAN):
                closure()
        except Exception as e:                  # noqa: BLE001 — keep alive
            err = e
        finally:
            t1 = time.perf_counter()
            self.exec_time += t1 - t0
            self._last_done = t1
            # the error is stashed in the same critical section that
            # completes the sequence, so any thread observing completion
            # (drain / cancel / a fence wait) also observes the error
            with self._cv:
                if err is not None and self.pending_error is None:
                    self.pending_error = err
                self._completed += 1
                seq = self._completed
                self._cv.notify_all()
            if es is not None and es.on:
                es.emit(_T.RunnerComplete(seq, t1 - t0, stalled))

    def _run(self):
        dq, cv = self._dq, self._cv
        while True:
            with cv:
                while not dq:
                    cv.wait()
                item = dq.popleft()
            if item is None:
                return
            self._run_one(*item)

    # ------------------------------------------------------------------
    # iteration window (stall accounting) + cancellation
    # ------------------------------------------------------------------
    def open_iteration(self) -> None:
        """Mark an iteration in flight: queue-empty time now counts as
        runner stall (the Python thread is the bottleneck)."""
        self._open = True

    def close_iteration(self) -> None:
        """Close the iteration window opened by :meth:`open_iteration`."""
        self._open = False

    def cancel(self) -> None:
        """Divergence cancellation: drain every submitted closure, close
        the iteration window and discard any stashed closure error — in
        one critical section, so no concurrently-completing closure can
        stash an error between the drain and the clear.  Errors raised by
        a cancelled iteration's closures are moot: its effects are rolled
        back and the validated prefix replays eagerly."""
        if self.lazy:
            try:
                self.run_pending_now()
            except Exception:           # noqa: BLE001 — cancelled anyway
                pass
            self._open = False
            self.pending_error = None
            return
        with self._cv:
            while self._completed < self._submitted:
                self._cv.wait()
            self._open = False
            self.pending_error = None

    def take_error(self) -> Exception:
        """Return and clear the first stashed closure error (the fetchless
        failure surfaced at ``engine.sync()``), or None."""
        err, self.pending_error = self.pending_error, None
        return err

    # ------------------------------------------------------------------
    def run_pending_now(self):
        """Lazy mode: execute queued work on the calling thread (this is
        the LazyTensor-style serialized evaluation of Table 2).  Every
        queued closure completes its sequence (fences stay monotone),
        then the first stashed error re-raises HERE — on the calling
        thread at the fetch/fence point, as serialized lazy evaluation
        must — rather than waiting silently for an explicit sync()."""
        dq = self._dq
        while True:
            try:
                item = dq.popleft()
            except IndexError:
                break
            if item is not None:
                self._run_one(*item)
        err = self.pending_error
        if err is not None:
            self.pending_error = None
            raise err

    def wait_for(self, seq: int):
        """Block until the seq-th submitted closure has run — the
        per-value fence wait (DESIGN.md §4.4).  FIFO order guarantees every
        earlier closure has also run."""
        if self.lazy:
            self.run_pending_now()
            return
        with self._cv:
            while self._completed < seq:
                self._cv.wait()

    def drain(self):
        """Block until every submitted closure has run (dispatch-complete;
        device work may still be in flight — see module docstring).

        This is the *full* barrier, reserved for ``engine.sync()`` /
        ``close()`` and divergence cancellation — variable reads and Output
        Fetching wait on their own producer's fence/future instead."""
        if self.lazy:
            self.run_pending_now()
            return
        with self._cv:
            while self._completed < self._submitted:
                self._cv.wait()

    def stop(self):
        if not self.lazy:
            with self._cv:
                self._dq.append(None)       # sentinel: not a counted closure
                self._cv.notify()
            # wait for the worker to leave: a daemon thread still inside
            # torch when the interpreter finalizes aborts the process
            if self._worker is not threading.current_thread():
                self._worker.join()
