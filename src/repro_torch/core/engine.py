"""Public Terra API.

``terra.function(fn)`` wraps an imperative step function: each call is one
iteration.  The first iterations run imperatively while traces are
collected; once the TraceGraph covers the latest trace, execution switches
to imperative-symbolic co-execution.  All Python features of ``fn`` keep
working in every phase — third-party calls, object mutation, data-dependent
control flow, generators, try/except — because the Python interpreter
always executes ``fn`` itself (as the skeleton program in the co-execution
phase).

``terra.imperative()`` runs a block under a purely imperative engine (the
paper's baseline): ops execute eagerly, nothing is compiled.

Both run on the CUDA card unless the caller passes ``device="cpu"``; with
no card and no explicit device they raise.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
from typing import Callable, Optional

from repro_torch.core.executor import SKELETON, TerraEngine
from repro_torch.core.executor import steady
from repro_torch.core.executor.families import feed_signature
from repro_torch.core.tensor import current_engine, set_current_engine


def _cache_scope(fn: Callable) -> str:
    """Process-stable digest identifying ``fn`` for the artifact store
    (DESIGN.md §14): module + qualname + a recursive fold over compiled
    bytecode, so two different step functions sharing a cache directory
    never hydrate each other's graphs, while restarting the process (or
    re-decorating the same source) keeps the scope stable."""
    h = hashlib.sha256()
    target = getattr(fn, "__func__", fn)
    h.update(f"{getattr(target, '__module__', '')}."
             f"{getattr(target, '__qualname__', repr(type(target)))}"
             .encode("utf-8"))

    def fold(code) -> None:
        h.update(code.co_code)
        for c in code.co_consts:
            if hasattr(c, "co_code"):
                fold(c)
    code = getattr(target, "__code__", None)
    if code is not None:
        fold(code)
    return h.hexdigest()[:16]


class TerraFunction:
    """An imperative DL program managed by the Terra runtime.

    Each call is keyed by a *shape-class signature* — the (shape, dtype) of
    the call's tensor arguments plus the avals of all bound Variables — and
    the engine keeps one TraceGraph (with its compiled segments) per shape
    class (DESIGN.md §8).  A batch-size or sequence-bucket change therefore
    switches to a sibling graph instead of discarding the current one; each
    shape class traces once, and flipping back is a dictionary lookup.
    ``max_families`` bounds the LRU of live shape classes; ``strict_feeds``
    controls whether a missing Input Feeding value on a taken path raises
    at dispatch time (default) or warns once and substitutes zeros.

    ``steady_state`` (opt-in, default 0 = off) enables zero-walker
    steady-state dispatch (executor/steady.py, DESIGN.md §12): after that
    many consecutive clean eligible iterations of one family, calls
    dispatch the compiled segment directly — ``fn`` is not executed — with
    every ``steady_probe``-th call forced through the full walker path.

    ``cache_dir`` (or ``$TERRA_CACHE_DIR``) enables the persistent artifact
    store (core/persist/, DESIGN.md §14): traced graphs and each compiled
    segment's plan are written to disk and hydrated on the next process
    start, so a warm boot reaches co-execution with zero retraces and zero
    segment recompiles (on a card the CUDA graphs are captured anew).
    ``save_checkpoint``/``restore_checkpoint`` persist the engine's
    Variable buffers and iteration counter for exact continuation.

    ``device`` is where the engine's variables, feeds and segments live:
    ``None`` means the CUDA card.
    """

    def __init__(self, fn: Callable, lazy: bool = False, seed: int = 0,
                 min_covered: int = 1, max_families: int = 8,
                 strict_feeds: bool = True, optimize=None,
                 steady_state: int = 0, steady_probe: int = 64,
                 cache_dir: Optional[str] = None, profile: int = 0,
                 device=None):
        self.fn = fn
        self.engine = TerraEngine(lazy=lazy, seed=seed,
                                  min_covered=min_covered,
                                  max_families=max_families,
                                  strict_feeds=strict_feeds,
                                  optimize=optimize,
                                  cache_dir=cache_dir,
                                  cache_scope=_cache_scope(fn),
                                  device=device)
        self.engine.steady_state = int(steady_state)
        self.engine.steady_probe = int(steady_probe)
        self.engine.steady_donated_bytes = 0    # steady.py's twin donates
        self.engine.profile_every = int(profile)
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        eng = self.engine
        prev = current_engine()
        set_current_engine(eng)
        try:
            with eng.events.span("engine.call", it=eng.iter_id):
                out = steady.try_steady(eng, args, kwargs)
                if out is steady.MISS:
                    eng._steady_poison = False
                    eng.start_iteration(feed_sig=feed_signature(args,
                                                                kwargs))
                    out = self.fn(*args, **kwargs)
                    eng.end_iteration()
                    steady.attach_futures(eng, out)
                    steady.observe(eng, args, kwargs, out)
        except BaseException:
            # leave the engine usable: cancel the half-open iteration and
            # roll back to its start snapshot before propagating
            eng.abort_iteration()
            raise
        finally:
            set_current_engine(prev)
        return out

    @property
    def phase(self) -> str:
        return "co-execution" if self.engine.mode == SKELETON else "tracing"

    @property
    def stats(self):
        return self.engine.stats

    def wait(self):
        """Block until all dispatched graph work (including async device
        execution behind the variable store) has completed."""
        self.engine.sync()

    def save_checkpoint(self, path: str) -> None:
        """Persist Variable buffers + iteration state for exact
        continuation in a fresh process (core/persist/checkpoint.py)."""
        self.engine.save_checkpoint(path)

    def restore_checkpoint(self, path: str) -> None:
        self.engine.restore_checkpoint(path)

    def close(self):
        self.engine.close()


def function(fn: Callable = None, *, lazy: bool = False, seed: int = 0,
             min_covered: int = 1, max_families: int = 8,
             strict_feeds: bool = True, optimize=None,
             steady_state: int = 0, steady_probe: int = 64,
             cache_dir: Optional[str] = None, profile: int = 0,
             device=None):
    """Decorator/factory: manage an imperative step function with Terra.

    ``optimize`` selects the symbolic optimization pipeline run over each
    shape family's TraceGraph before segment compilation (DESIGN.md §10):
    ``"all"`` (default; adds kernel substitution on CUDA), ``"safe"``
    (no constant-feed folding — for drivers whose feeds change per call),
    ``"none"`` (compile the trace verbatim, the pre-pass behaviour), or an
    explicit tuple of pass names.  ``None`` defers to ``$TERRA_OPTIMIZE``.

    ``cache_dir`` enables the persistent artifact store for warm boots
    (DESIGN.md §14); ``None`` defers to ``$TERRA_CACHE_DIR`` (unset: off).

    ``profile`` (opt-in, default 0 = off) samples device-time attribution
    every ``profile``-th iteration (DESIGN.md §15): on a sampled iteration
    the GraphRunner thread times each segment and emits a
    ``SegmentProfile`` event splitting host dispatch time from device
    time.  On a CUDA card the device time is the elapsed time between two
    CUDA events recorded on the current stream around the segment call;
    on the CPU it is the call's host wall.  Requires a structured event
    processor to be attached; non-sampled iterations stay zero-overhead.

    ``device`` (default ``None``: the CUDA card) is where the engine runs;
    without a card the call raises unless ``device="cpu"`` is passed.
    """
    kw = dict(lazy=lazy, seed=seed, min_covered=min_covered,
              max_families=max_families, strict_feeds=strict_feeds,
              optimize=optimize, steady_state=steady_state,
              steady_probe=steady_probe, cache_dir=cache_dir,
              profile=profile, device=device)
    if fn is None:
        return lambda f: TerraFunction(f, **kw)
    return TerraFunction(fn, **kw)


@contextlib.contextmanager
def imperative(seed: int = 0, device=None):
    """Pure imperative execution (the paper's TensorFlow-eager baseline).

    Every iteration is traced and discarded; ops run eagerly; Variables
    work.  Use ``imp.step()`` to delimit iterations when measuring, or just
    run — the engine treats the whole block as one iteration.
    """
    eng = TerraEngine(seed=seed, device=device)
    eng.min_covered = 10**9            # never switch to co-execution
    prev = current_engine()
    set_current_engine(eng)
    eng.start_iteration()

    class _Imp:
        engine = eng

        @staticmethod
        def step():
            eng.end_iteration()
            eng.start_iteration()

    try:
        yield _Imp
    finally:
        try:
            eng.end_iteration()
        except Exception:
            pass
        set_current_engine(prev)
        eng.close()
