"""Thin emit helpers for the executor's instrumentation sites.

Each helper folds the hot-path discipline in: it checks ``es.on`` first
and constructs the event object only when a structured processor is
attached — so an instrumented site is exactly one function call on the
counters-only path (DESIGN.md §13).  Serving-side emission lives in
serve/scheduler/telemetry.py against the same stream.
"""

from __future__ import annotations

import zlib

from repro_torch.core.events import types as T


def fam_digest(key) -> str:
    """Short, process-stable digest of a family key for event payloads
    (full keys embed shape tuples; events only need a join key)."""
    return format(zlib.crc32(repr(key).encode()), "08x")


def iteration_start(es, iter_id, mode, key) -> None:
    if es.on:
        es.emit(T.IterationStart(iter_id, mode, fam_digest(key)))


def iteration_end(es, iter_id, mode, traced, ops=0, fast=0) -> None:
    if es.on:
        es.emit(T.IterationEnd(iter_id, mode, traced, ops, fast))


def transition(es, iter_id) -> None:
    if es.on:
        es.emit(T.Transition(iter_id))


def family_switch(es, key, created) -> None:
    if es.on:
        es.emit(T.FamilySwitch(fam_digest(key), created))


def segment_dispatch(es, iter_id, kind, index, seq, feeds=0) -> None:
    if es.on:
        es.emit(T.SegmentDispatch(iter_id, kind, index, seq, feeds))


def runner_complete(es, seq, wall, stall) -> None:
    if es.on:
        es.emit(T.RunnerComplete(seq, wall, stall))


def segment_profile(es, iter_id, kind, index, dispatch, device,
                    kernels=()) -> None:
    if es.on:
        es.emit(T.SegmentProfile(iter_id, kind, index, dispatch, device,
                                 tuple(kernels)))


def fork_observed(es, key, fork, case) -> None:
    if es.on:
        es.emit(T.ForkObserved(fam_digest(key), fork, case))


def divergence(es, iter_id, reason) -> None:
    if es.on:
        es.emit(T.Divergence(iter_id, str(reason)))


def rollback(es, iter_id, vars_restored=0) -> None:
    if es.on:
        es.emit(T.Rollback(iter_id, vars_restored))


def replay(es, iter_id, entries=0) -> None:
    if es.on:
        es.emit(T.Replay(iter_id, entries))


def retrace(es, iter_id, reason="") -> None:
    if es.on:
        es.emit(T.Retrace(iter_id, reason))


def steady_enter(es, iter_id, key) -> None:
    if es.on:
        es.emit(T.SteadyEnter(iter_id, fam_digest(key)))


def steady_exit(es, iter_id, reason) -> None:
    if es.on:
        es.emit(T.SteadyExit(iter_id, reason))


def steady_probe(es, iter_id) -> None:
    if es.on:
        es.emit(T.SteadyProbe(iter_id))


def steady_poison(es, iter_id) -> None:
    if es.on:
        es.emit(T.SteadyPoison(iter_id))


def pass_run(es, iter_id, key, pipeline, deltas) -> None:
    if es.on:
        es.emit(T.PassPipelineRun(iter_id, fam_digest(key),
                                  tuple(pipeline), deltas))


def artifact_hit(es, kind, key) -> None:
    if es.on:
        es.emit(T.ArtifactHit(kind, str(key)))


def artifact_miss(es, kind, key, reason="") -> None:
    if es.on:
        es.emit(T.ArtifactMiss(kind, str(key), reason))


def artifact_store(es, kind, key, nbytes=0) -> None:
    if es.on:
        es.emit(T.ArtifactStore(kind, str(key), nbytes))


def checkpoint_save(es, path, vars_saved=0, requests=0) -> None:
    if es.on:
        es.emit(T.CheckpointSave(str(path), vars_saved, requests))


def checkpoint_restore(es, path, vars_restored=0, requests=0) -> None:
    if es.on:
        es.emit(T.CheckpointRestore(str(path), vars_restored, requests))
