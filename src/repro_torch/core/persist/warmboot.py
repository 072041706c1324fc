"""PersistLayer: warm-boot glue between the engine and the ArtifactStore.

Three artifact kinds (DESIGN.md §14):

* **family records** (``fam/<dir>/<vars>.json``) — serialized TraceGraph +
  pass observations + variable avals, written after every GraphProgram
  regeneration and on LRU eviction.  A cold ``FamilyManager`` miss whose
  feed signature matches a record hydrates the graph and rebuilds the
  GraphProgram by replaying the pass pipeline — no tracing.  Legality:
  the Walker still validates the hydrated graph op-by-op on its first
  iteration; any mismatch diverges into a fresh trace and deletes the
  record ("slower never wrong").
* **segment artifacts** (``seg/<digest>.json``) — each compiled
  segment's build (aot.py), consulted by ``SegmentCache.get_or_build``
  through the ``loader`` hook (a load is a cache HIT:
  ``segments_recompiled`` stays 0, ``aot_loads`` counts it).
* **engine checkpoints** — see checkpoint.py (plain directories, not
  content-addressed).

Every failure mode — unreadable file, schema violation, aval conflict,
malformed segment artifact — is a clean miss that falls back to the
ordinary trace/compile path.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

from repro_torch.core.events import emit as ev
from repro_torch.core.persist import aot, codec, keys
from repro_torch.core.persist.store import ArtifactStore

_NEVER_HYDRATE = 10 ** 9        # engine.imperative() sets min_covered here


def open_persist(cache_dir: Optional[str], events, scope: str, engine
                 ) -> Optional["PersistLayer"]:
    """The engine's PersistLayer, enabled by an explicit ``cache_dir`` or
    ``$TERRA_CACHE_DIR``; ``cache_dir=""`` disables caching even with the
    env var set (None: off)."""
    root = (os.environ.get("TERRA_CACHE_DIR") if cache_dir is None
            else cache_dir)
    if not root:
        return None
    return PersistLayer(root, events, scope=scope, engine=engine)


class PersistLayer:
    """One per engine; owns the store handle and the hit/miss accounting."""

    def __init__(self, root: str, events, scope: str, engine):
        self.store = ArtifactStore(root, keys.namespace(engine.device))
        self.events = events
        self.stats = events.counters
        self.scope = scope
        self.engine = engine
        self.segments_dropped = 0   # in-memory evictions (disk blobs kept)

    # -- accounting ---------------------------------------------------------
    def _hit(self, kind: str, ref: str) -> None:
        self.stats["artifact_hits"] += 1
        ev.artifact_hit(self.events, kind, ref)

    def _miss(self, kind: str, ref: str, reason: str) -> None:
        self.stats["artifact_misses"] += 1
        ev.artifact_miss(self.events, kind, ref, reason)

    def _stored(self, kind: str, ref: str, nbytes: int) -> None:
        self.stats["artifacts_stored"] += 1
        ev.artifact_store(self.events, kind, ref, nbytes)

    # -- family records -------------------------------------------------------
    def save_family(self, fam) -> None:
        """Persist one family's graph + observations.  Skipped (never an
        error) when the family has no program yet, is still an unconfirmed
        hydration, or references state the record cannot describe."""
        eng = self.engine
        if fam.gp is None or eng is None or fam.hydrated:
            return
        reldir = keys.family_dir(self.scope, fam.key[0])
        if reldir is None:
            return
        var_avals = dict(fam.gp.var_avals)
        tombs = {vid: (tuple(s), dt)
                 for vid, (s, dt) in eng.store.tombstones.items()}
        if codec.collect_var_ids(fam.tg) - set(var_avals) - set(tombs):
            return              # graph reads vars we cannot placehold
        name = keys.record_name(var_avals)
        if name is None:
            return
        try:
            doc = codec.family_record(fam.tg, fam.feed_obs, fam.fetch_obs,
                                      fam.key[0], var_avals, tombs,
                                      eng.pipeline)
        except codec.CodecError:
            return
        rel = f"{reldir}/{name}"
        nbytes = self.store.write_json(rel, doc)
        if nbytes:
            fam._persist_rec = rel
            self._stored("family", rel, nbytes)

    def hydrate_family(self, key: Tuple, engine) -> Optional[Any]:
        """Rebuild a TraceFamily from disk for a cold activation, or None
        (the ordinary fresh-trace path).  Candidates under the (scope,
        feed_signature) directory are tried newest-first; one whose
        variable avals conflict with live state is skipped, and a
        malformed one is deleted."""
        if engine.min_covered >= _NEVER_HYDRATE:
            return None         # imperative baseline never hydrates
        reldir = keys.family_dir(self.scope, key[0])
        if reldir is None:
            return None
        names = self.store.list(reldir)
        if not names:
            self._miss("family", reldir, "absent")
            return None
        for name in names:
            fam = self._try_hydrate(f"{reldir}/{name}", key, engine)
            if fam is not None:
                return fam
        self._miss("family", reldir, "no-usable-candidate")
        return None

    def _try_hydrate(self, rel: str, key: Tuple, engine) -> Optional[Any]:
        doc = self.store.read_json(rel)
        if doc is None:
            self.store.delete(rel)      # unreadable/truncated: clean miss
            return None
        live = engine.store.vars
        try:
            rec = codec.parse_family_record(doc)
        except codec.CodecError:
            self.store.delete(rel)      # schema violation: clean miss
            return None
        if rec.feed_sig != key[0]:
            return None
        for vid, aval in rec.var_avals.items():
            v = live.get(vid)
            if v is not None and v.aval != aval:
                return None             # conflicting live state: skip
        try:
            rec.tg.family_key = key
            gp = self._build_program(rec, key, engine)
        except Exception:
            self.store.delete(rel)      # unbuildable record: clean miss
            return None
        # vars the record describes but this process hasn't registered yet
        # get tombstone placeholders: dead-branch reads need an aval, and
        # ensure() clears the tombstone the moment the real var registers
        for vid, aval in rec.var_avals.items():
            if vid not in live:
                engine.store.tombstones.setdefault(
                    vid, (tuple(aval.shape), aval.dtype))
        for vid, (shape, dt) in rec.tombstones.items():
            if vid not in live:
                engine.store.tombstones.setdefault(vid, (tuple(shape), dt))
        from repro_torch.core.executor.families import TraceFamily
        fam = TraceFamily(key, rec.tg, gp, mode="skeleton",
                          covered_streak=engine.min_covered,
                          feed_obs=rec.feed_obs, fetch_obs=rec.fetch_obs)
        fam.hydrated = True
        fam._persist_rec = rel
        self.stats["warm_families"] += 1
        self._hit("family", rel)
        return fam

    def _build_program(self, rec, key, engine):
        from repro_torch.core.graphgen import GraphProgram
        from repro_torch.core.passes import run_passes
        # replay the pass pipeline with the CURRENT engine configuration:
        # observations are pipeline-independent facts, so a record written
        # under a different $TERRA_OPTIMIZE hydrates correctly
        va = dict(rec.var_avals)
        opt = run_passes(rec.tg, va, engine.pipeline, rec.feed_obs,
                         rec.fetch_obs, backend=engine.device.type)
        gp = GraphProgram(rec.tg, va, seg_cache=engine.seg_cache,
                          family_key=key, opt=opt, device=engine.device,
                          capture=engine.capture)
        gp.opt_token = (engine.pipeline, rec.feed_obs.version,
                        rec.fetch_obs.version)
        return gp

    def on_family_evicted(self, fam) -> None:
        """LRU eviction callback: save the victim's graph (if it isn't on
        disk already) so the eviction is reversible via hydration."""
        if fam._persist_rec is None:
            self.save_family(fam)

    def on_hydrated_divergence(self, fam) -> None:
        """The hydrated graph failed first-iteration validation: the record
        describes a different program — delete it (the fresh trace's save
        overwrites the slot)."""
        if fam._persist_rec is not None:
            self.store.delete(fam._persist_rec)
            fam._persist_rec = None

    # -- segment artifacts ------------------------------------------------
    def _segment_rel(self, gp, sp) -> Optional[str]:
        va = tuple(sorted((v, gp.var_avals[v]) for v in sp.var_reads
                          if v in gp.var_avals))
        return keys.segment_rel(sp.signature, va)

    def load_segment(self, gp, sp, jit_each: bool) -> Optional[Any]:
        """SegmentCache ``loader`` hook: the segment callable built from
        its on-disk artifact without the compile-time analyses, or None
        (in-memory miss semantics; builder runs next)."""
        if not jit_each:
            return None
        rel = self._segment_rel(gp, sp)
        if rel is None:
            return None
        doc = self.store.read_json(rel)
        if doc is None:
            self._miss("segment", rel, "absent")
            return None
        try:
            fn = gp._segment_fn(sp, aot.load_build(gp, sp, doc))
        except Exception:
            self.store.delete(rel)      # stale/corrupt artifact: clean miss
            self._miss("segment", rel, "corrupt")
            return None
        self.stats["aot_loads"] += 1
        self._hit("segment", rel)
        return fn

    def build_segment(self, gp, sp, jit_each: bool) -> Any:
        """SegmentCache ``builder`` hook: run the segment's analyses,
        write its artifact to disk and build the callable; a segment the
        codec cannot describe is built without an artifact."""
        if not jit_each:
            return gp._compile_segment(sp, jit_each)
        build = gp.segment_build(sp)
        rel = self._segment_rel(gp, sp)
        if rel is not None:
            try:
                doc = aot.segment_artifact(gp, sp, build)
            except codec.CodecError:
                doc = None
            if doc is not None:
                nbytes = self.store.write_json(rel, doc)
                if nbytes:
                    self._stored("segment", rel, nbytes)
        return gp._segment_fn(sp, build)

    def on_segments_evicted(self, dropped: List) -> None:
        """SegmentCache.retain callback.  Nothing to write: artifacts were
        written at build time and deliberately survive in-memory eviction
        — that is what lets an evicted-then-reactivated family reload
        instead of recompiling."""
        self.segments_dropped += len(dropped)
