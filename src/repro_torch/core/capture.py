"""Captured segments: the port's counterpart of ``jax.jit`` for a segment.

The reference compiles each segment with ``jax.jit(seg_fn,
donate_argnums=(0,))`` and each chain with ``jax.jit``.  On a CUDA card
the port records the segment's kernels once into a CUDA graph
(``torch.cuda.CUDAGraph``) and afterwards launches the whole graph with
one call, so a step costs one launch instead of one Python dispatch per
op.  On the CPU the callables stay eager: that is what the caller asked
for.

:class:`CapturedFn` wraps an eager callable ``fn(*args)`` whose arguments
are (nested tuples and lists of) tensors and host values, and whose result
is a tree of tensors.

* **Graph key.**  One graph per key: the host values (a segment passes
  only the Case Select / Loop Cond slots it reads, through ``host``), and
  the shape, dtype, strides and device of every tensor argument.
* **Call order.**  Call 1 of a key runs ``fn`` eagerly on the side
  stream: it is the warm-up that builds the kernels, sets their
  shared-memory attributes and caches device-resident constants (and
  cuBLAS's workspace for that stream).  Call 2 captures and replays;
  call 3 and later replay.  A shape seen once never pays for a capture.
* **Inputs.**  A tensor argument whose address was the same in calls 1
  and 2 is read *in place* by the graph (parameters, a donated pool): no
  copy.  Any other argument gets a static buffer that each call copies
  into.  An in-place argument that later arrives at another address
  re-captures its graph with a static buffer there (``recaptures``).
* **Donation.**  Arguments named in ``donate`` may be written by ``fn``
  (the segment writes a donated variable's new value into its input
  buffer).  After a replay the caller's donated tensor holds the new
  value: the graph wrote it in place, or it is copied back from the static
  buffer.
* **Home buffers.**  ``wrap(..., home=True)`` (a steady iteration's
  segment, which no snapshot can hold: core/graphgen.py) gives every
  donated tensor argument one *home* buffer that the graph owns: the
  caller's tensor of call 2 when it kept its address since call 1, else
  a new one.  A replay copies the caller's tensor into the home buffer
  only when it is not the home buffer (after a prefill's splice or a
  walker probe wrote the variable elsewhere; ``home_copies`` counts such
  replays), and hands the home buffer back as the donated variable's new
  value: no copy back, no copy out, and no recapture when the caller's
  tensor moves.  ``copy_in_bytes`` counts the copies made.
* **Ownership.**  A replay overwrites the graph's outputs.  Every output
  escapes into state that outlives the next replay — variable writes
  become the store's committed values and the divergence snapshot's
  iteration-start buffers, fetches go to Python, the steady path keeps
  its fetches, and a carry from one segment to the next may be consumed
  after another graph of the same pool ran — so each output is copied
  into a tensor the caller owns, right after the replay and in stream
  order (``copy_out_bytes``).  An output that *is* an argument is handed
  back as the caller's own tensor.  Because nothing a graph produced is
  read after another replay, the graphs of one engine can share one
  memory pool (``torch.cuda.graph_pool_handle()``) in any replay order.
* **Launch counters.**  The kernel wrappers count their launches when
  called; a replay does not call them.  A capture records the launches
  its own thread counted (other threads may launch meanwhile), takes
  them back off the counters, and every replay adds them.
* **Pool copies.**  A pool op's in-place form copies each new pool leaf
  it could not write in place into its pool input (the recurrent states'
  write-back, ``serve/scheduler/inplace.py``), and reports the bytes
  through :func:`count_pool_copy`; a capture records what its own thread
  reported, and every replay adds it to ``pool_copy_bytes``.
* **Errors.**  A capture that fails raises; nothing falls back to eager.
  An op that cannot be captured is registered so (``def_op(...,
  capturable=False)``), and a segment or chain holding one is compiled
  eager (:meth:`CaptureContext.eager`, counted in ``eager_fns``).
* **Threads.**  Warm-ups and captures run on one side stream per device,
  one at a time in the process (``_CAPTURING``: a capture records all
  work queued on its stream, whichever thread queues it), in
  ``thread_local`` error mode, so the Python thread may stage feeds onto
  the card meanwhile.  Replays run on the caller's current stream.
* **Spans.**  With a span recorder on the context's event stream (its
  engine's), each replay records ``capture.copy_in``, ``capture.replay``,
  ``capture.copy_back`` and ``capture.copy_out``, each timed on the card
  as well (``device=True``), and each capture or recapture
  ``capture.record``.
* **Destroying graphs.**  Destroying a CUDA graph is not permitted on a
  thread that is capturing, and Python's cyclic collector may free a
  closed engine's graphs on any thread, in the middle of a capture.  So
  a graph is never destroyed where its last reference drops: it is
  retired to a list, and retired graphs are destroyed under the
  process's capture lock (before a capture begins, and when a context
  is released), when no capture is running.

:func:`disable_jit` is the counterpart of ``jax.disable_jit``: segments
and chains compiled under it are eager.  It is the "before" arm of the
card's capture checks.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.events import EventStream
from repro_torch.core.pytree import tree_flatten, tree_unflatten
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.build import recording_launches

_COUNTED = tuple(getattr(kernel_ops, n) for n in kernel_ops.__all__)
_DISABLED = [0]
_LOCK = threading.Lock()
_CAPTURING = threading.Lock()     # held by every warm-up and capture
_RETIRED: list = []               # graphs whose owner died, not destroyed
_STREAMS: Dict[int, torch.cuda.Stream] = {}     # the side stream per card


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    with _LOCK:
        if idx not in _STREAMS:
            _STREAMS[idx] = torch.cuda.Stream(idx)
        return _STREAMS[idx]


def _bury() -> None:
    """Destroy the retired graphs (the caller holds ``_CAPTURING``)."""
    while _RETIRED:
        _RETIRED.pop()


@contextlib.contextmanager
def disable_jit():
    """Compile segments and chains eager while the block runs (process
    wide, like ``jax.disable_jit``; the GraphRunner thread compiles too)."""
    with _LOCK:
        _DISABLED[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _DISABLED[0] -= 1


def jit_disabled() -> bool:
    return _DISABLED[0] > 0


_POOL_COPIES = threading.local()    # .bytes: open in this thread's capture


def count_pool_copy(nbytes: int) -> None:
    """Report ``nbytes`` copied into a pool input inside the function
    being captured on this thread (nothing is counted outside a capture)."""
    if getattr(_POOL_COPIES, "bytes", None) is not None:
        _POOL_COPIES.bytes += nbytes


class CaptureContext:
    """One engine's graphs: their shared memory pool, the card's side
    stream that warm-ups and captures run on, and the counters
    ``chip_smoke.py`` reads (graphs captured, replays, recaptures,
    warm-ups, functions compiled eager because they hold an op that
    cannot be captured, the bytes copied in and out around replays, and
    the bytes replays copy into pool leaves, ``pool_copy_bytes``).
    ``events`` is the stream its spans go to."""

    def __init__(self, device: torch.device,
                 events: Optional[EventStream] = None):
        self.device = device
        self.events = events if events is not None else EventStream()
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = _side_stream(device)
        self.stats: Dict[str, int] = dict(
            graphs=0, replays=0, recaptures=0, warmups=0, eager_fns=0,
            copy_in_bytes=0, copy_out_bytes=0, home_copies=0,
            pool_copy_bytes=0)
        self._fns: "weakref.WeakSet[CapturedFn]" = weakref.WeakSet()

    def wrap(self, fn: Callable, donate: Sequence[int] = (),
             host: Optional[Callable] = None,
             home: bool = False) -> "CapturedFn":
        cf = CapturedFn(fn, self, donate, host, home)
        self._fns.add(cf)
        return cf

    def eager(self, fn: Callable) -> Callable:
        """``fn`` as it is: it holds an op that cannot be captured."""
        self.stats["eager_fns"] += 1
        return fn

    def release(self) -> None:
        """Drop every graph and static buffer (engine close)."""
        for cf in list(self._fns):
            cf.release()
        with _CAPTURING:
            _bury()


def context_for(device: torch.device,
                events: EventStream) -> Optional[CaptureContext]:
    """An engine's CaptureContext on a CUDA card; None on the CPU, where
    segments and chains stay eager."""
    return CaptureContext(device, events) if device.type == "cuda" else None


def release(ctx: Optional[CaptureContext]) -> None:
    """Drop ``ctx``'s graphs (nothing to drop without one)."""
    if ctx is not None:
        ctx.release()


class _Graph:
    """One captured key: the graph, how each tensor argument reaches it
    (``static[j]`` is (a buffer copied into, donated?), or None when the
    graph reads the caller's tensor at ``ptrs[j]`` or its home buffer),
    the home buffers ((buffer, leaf index) pairs), and how each output
    leaves it."""

    __slots__ = ("graph", "static", "ptrs", "homes", "outs", "out_def",
                 "delta", "copy_in", "copy_back", "copy_out", "in_bytes",
                 "out_bytes", "pool_bytes", "__weakref__")


class _Entry:
    __slots__ = ("ptrs", "copied", "g")

    def __init__(self, ptrs):
        self.ptrs = ptrs            # call 1's argument addresses
        self.copied: set = set()    # argument slots read through a copy
        self.g: Optional[_Graph] = None


class CapturedFn:
    """``fn`` run eagerly once per key, then captured and replayed (see
    the module docstring)."""

    def __init__(self, fn: Callable, ctx: CaptureContext,
                 donate: Sequence[int] = (), host: Optional[Callable] = None,
                 home: bool = False):
        self.fn = fn
        self.ctx = ctx
        self.donate = tuple(donate)
        self.host = host
        self.home = home
        self._entries: Dict[Any, _Entry] = {}

    def release(self) -> None:
        self._entries.clear()

    # ------------------------------------------------------------------
    def __call__(self, *args):
        leaves, treedef = tree_flatten(args)
        tix = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        host = (self.host(*args) if self.host is not None else tuple(
            _host_key(x) for x in leaves if not isinstance(x, torch.Tensor)))
        key = (treedef, host, tuple((leaves[i].shape, leaves[i].dtype,
                                     leaves[i].stride(), leaves[i].device)
                                    for i in tix))
        ent = self._entries.get(key)
        if ent is None:
            self._entries[key] = _Entry([leaves[i].data_ptr() for i in tix])
            return self._warmup(args)
        if ent.g is None:
            stable = [leaves[i].data_ptr() == p
                      for i, p in zip(tix, ent.ptrs)]
            ent.copied = {j for j, s in enumerate(stable) if not s}
            ent.g = self._capture(args, leaves, treedef, tix, ent.copied)
        else:
            g = ent.g
            moved = {j for j, (i, p) in enumerate(zip(tix, g.ptrs))
                     if g.static[j] is None and p is not None
                     and leaves[i].data_ptr() != p}
            if moved:
                ent.copied |= moved
                ent.g = None                # drop the old graph first
                self.ctx.stats["recaptures"] += 1
                ent.g = self._capture(args, leaves, treedef, tix,
                                      ent.copied)
        return self._replay(ent.g, leaves)

    # ------------------------------------------------------------------
    def _warmup(self, args):
        stream, cur = self.ctx.stream, torch.cuda.current_stream()
        with _CAPTURING:
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                out = self.fn(*args)
            cur.wait_stream(stream)
        self.ctx.stats["warmups"] += 1
        return out

    def _donated_leaves(self, args) -> set:
        """Leaf indices of the donated arguments."""
        out, start = set(), 0
        for a, arg in enumerate(args):
            n = len(tree_flatten(arg)[0])
            if a in self.donate:
                out.update(range(start, start + n))
            start += n
        return out

    def _capture(self, args, leaves, treedef, tix, copied) -> _Graph:
        with self.ctx.events.span("capture.record"):
            return self._record(args, leaves, treedef, tix, copied)

    def _record(self, args, leaves, treedef, tix, copied) -> _Graph:
        ctx = self.ctx
        g = _Graph()
        donated = self._donated_leaves(args)
        static_leaves = list(leaves)
        g.static, g.ptrs, g.homes = [], [], []
        for j, i in enumerate(tix):
            x = leaves[i]
            if self.home and i in donated:
                # the graph's own buffer: call 2's tensor when it stayed put
                # (the caller owns nothing else), else a new one that each
                # replay fills until the caller hands the home buffer back
                if j in copied:
                    x = static_leaves[i] = torch.empty_like(x)
                g.homes.append((x, i))
                g.static.append(None)
                g.ptrs.append(None)
                continue
            if j in copied:
                s = x.clone()
                static_leaves[i] = s
                g.static.append((s, i in donated))
            else:
                g.static.append(None)
            g.ptrs.append(static_leaves[i].data_ptr())
        static_args = tree_unflatten(treedef, static_leaves)
        graph = torch.cuda.CUDAGraph()
        # the graph goes to _RETIRED when its _Graph dies, wherever
        weakref.finalize(g, _RETIRED.append, graph)
        with _CAPTURING:
            _bury()
            _POOL_COPIES.bytes = 0
            try:
                with recording_launches() as rec, torch.cuda.graph(
                        graph, pool=ctx.pool, stream=ctx.stream,
                        capture_error_mode="thread_local"):
                    out = self.fn(*static_args)
            finally:
                g.pool_bytes, _POOL_COPIES.bytes = _POOL_COPIES.bytes, None
        g.delta = [rec.get(f, 0) for f in _COUNTED]
        for f, d in zip(_COUNTED, g.delta):
            f.launches -= d                 # recorded, not launched yet
        out_leaves, g.out_def = tree_flatten(out)
        by_id = {id(static_leaves[i]): i for i in tix}
        homes = {id(h): h for h, _ in g.homes}
        outs: List[Tuple] = []
        first: Dict[int, int] = {}
        for k, o in enumerate(out_leaves):
            if not isinstance(o, torch.Tensor):
                outs.append(("const", o))
            elif id(o) in homes:            # the same tensor every replay
                outs.append(("const", homes[id(o)]))
            elif id(o) in by_id:
                outs.append(("arg", by_id[id(o)]))
            elif id(o) in first:
                outs.append(("same", first[id(o)]))
            else:
                first[id(o)] = k
                outs.append(("copy", o))
        g.outs = outs
        g.graph = graph
        # the copies around a replay, each one multi-tensor launch
        pairs = [(st, i) for st, i in zip(g.static, tix) if st is not None]
        g.copy_in = ([st[0] for st, _ in pairs], [i for _, i in pairs])
        g.copy_back = ([st[0] for st, _ in pairs if st[1]],
                       [i for st, i in pairs if st[1]])
        g.copy_out = [v for kind, v in outs if kind == "copy"]
        g.in_bytes = sum(t.nbytes for t in g.copy_in[0])
        g.out_bytes = sum(t.nbytes for t in g.copy_out)
        ctx.stats["graphs"] += 1
        return g

    def _replay(self, g: _Graph, leaves):
        stats, span = self.ctx.stats, self.ctx.events.span
        statics, idx = g.copy_in
        srcs = [leaves[i] for i in idx]
        in_bytes = g.in_bytes
        moved = [(h, leaves[i]) for h, i in g.homes
                 if leaves[i].data_ptr() != h.data_ptr()]
        if moved:
            statics = statics + [h for h, _ in moved]
            srcs += [x for _, x in moved]
            in_bytes += sum(h.nbytes for h, _ in moved)
            stats["home_copies"] += 1
        if statics:
            with span("capture.copy_in", device=True):
                torch._foreach_copy_(statics, srcs)
        with span("capture.replay", device=True):
            g.graph.replay()
        for f, d in zip(_COUNTED, g.delta):
            if d:
                f.launches += d
        statics, idx = g.copy_back          # donated arguments' new values
        if statics:
            with span("capture.copy_back", device=True):
                torch._foreach_copy_([leaves[i] for i in idx], statics)
        fresh = [torch.empty_like(v) for v in g.copy_out]
        if fresh:
            with span("capture.copy_out", device=True):
                torch._foreach_copy_(fresh, g.copy_out)
        stats["replays"] += 1
        stats["copy_in_bytes"] += in_bytes
        stats["copy_out_bytes"] += g.out_bytes
        stats["pool_copy_bytes"] += g.pool_bytes
        res, it = [], iter(fresh)
        for kind, v in g.outs:
            if kind == "const":
                res.append(v)
            elif kind == "arg":
                res.append(leaves[v])
            elif kind == "same":
                res.append(res[v])
            else:
                res.append(next(it))
        return tree_unflatten(g.out_def, res)


def _host_key(x) -> Any:
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    return x
