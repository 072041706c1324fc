"""Persistent artifact store + engine checkpoint/restore (DESIGN.md §14).

Warm-boot co-execution: with ``$TERRA_CACHE_DIR`` set (or ``cache_dir``
passed to :func:`repro_torch.core.engine.function`), every GraphProgram
regeneration persists the family's TraceGraph + pass observations and
every compiled segment's build (its item list, liveness and donation
plan).  A fresh process hydrates them instead of tracing and analysing —
zero retraces, zero segment recompiles — while the Walker still
validates the hydrated graph op-by-op on the first iteration ("slower
never wrong").  On a card each segment's CUDA graph is captured anew on
its second call: graphs do not persist.

Module map:

* codec.py — strict tagged round-trip of TraceGraphs and observations
* keys.py — sha256 cache keys + the versioned store namespace
* store.py — atomic content-addressed file store
* aot.py — the segment artifact (the counterpart of AOT executables)
* warmboot.py — :class:`PersistLayer`, the engine-facing glue
* checkpoint.py — :func:`save_engine` / :func:`restore_engine`

Usage::

    os.environ["TERRA_CACHE_DIR"] = "/var/cache/terra"   # before the call
    step = terra.function(train_step)    # warm-boots automatically

    step.engine.save_checkpoint("ckpt/")             # process A
    step.engine.restore_checkpoint("ckpt/")          # process B, then call
"""

from repro_torch.core.persist.checkpoint import restore_engine, save_engine
from repro_torch.core.persist.warmboot import PersistLayer

__all__ = ["PersistLayer", "save_engine", "restore_engine"]
