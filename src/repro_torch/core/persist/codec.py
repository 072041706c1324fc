"""Strict tagged-value codec for persisted artifacts (DESIGN.md §14).

Family records round-trip TraceGraphs, loop bodies and pass observations
through JSON with the strictness discipline of events/schema.py: every
value is a ``[tag, ...]`` list; unknown tags or unencodable values raise
:class:`CodecError`, which the persist layer treats as a clean cache miss
— never a wrong load.  Deliberately NOT serialized (DESIGN.md §14):
``TGNode.entry_stamp`` (``hash()`` is salted per process; the Walker
re-stamps on first structural acceptance) and ``LoopBody.out_slot_for``
(a closure; rebuilt from the persisted ``_last_ordinals``).

The wire format is the reference's: an aval's ``torch.dtype`` goes by its
short name (``"bfloat16"``), arrays as raw numpy bytes with their dtype
name.  Nothing on the load path unpickles."""

from __future__ import annotations

import base64
import json
from typing import Set, Tuple

import numpy as np
import torch

from repro_torch.core.ops import Const
from repro_torch.core.passes.analysis import (FeedObservations,
                                              FetchObservations,
                                              FoldedConst, _VARYING)
from repro_torch.core.trace import (Aval, FeedRef, Ref, TraceEntry, VarRef,
                                    dtype_name)
from repro_torch.core.tracegraph import (LoopBody, TGNode, TraceGraph,
                                         make_out_slot_for)

FORMAT = 1
MAX_ARRAY_BYTES = 1 << 16       # matches analysis.MAX_FOLD_BYTES


class CodecError(ValueError):
    """Value outside the persistable set (encode) or a malformed /
    unknown tag (decode)."""


def _json_key(enc) -> str:
    # encoded values are nested lists of JSON primitives: dumping them is
    # a deterministic total order for canonicalizing sets/dicts
    return json.dumps(enc, sort_keys=True, separators=(",", ":"))


def _enc_array(a) -> list:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:   # numpy has no bfloat16
            raise CodecError("bfloat16 arrays are not persisted")
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a)
    if a.dtype == object or a.nbytes > MAX_ARRAY_BYTES:
        raise CodecError(f"array not persistable: {a.dtype} {a.nbytes}B")
    return [list(a.shape), str(a.dtype),
            base64.b64encode(a.tobytes()).decode("ascii")]


def _dec_array(shape, dtype, b64) -> np.ndarray:
    raw = base64.b64decode(b64.encode("ascii"))
    arr = np.frombuffer(raw, dtype=np.dtype(dtype))
    return arr.reshape(tuple(shape)).copy()


def encode(v) -> list:
    """Encode one value as a tagged JSON-native list."""
    if v is None:
        return ["n"]
    if isinstance(v, bool):
        return ["b", v]
    if isinstance(v, int):
        return ["i", v]
    if isinstance(v, float):
        return ["f", v]
    if isinstance(v, str):
        return ["s", v]
    if isinstance(v, tuple):
        return ["t", [encode(x) for x in v]]
    if isinstance(v, list):
        return ["l", [encode(x) for x in v]]
    if isinstance(v, (set, frozenset)):
        return ["set", sorted((encode(x) for x in v), key=_json_key)]
    if isinstance(v, dict):
        items = [[encode(k), encode(x)] for k, x in v.items()]
        items.sort(key=lambda kv: _json_key(kv[0]))
        return ["d", items]
    if isinstance(v, Aval):
        return ["aval", list(v.shape), dtype_name(v.dtype)]
    if isinstance(v, Ref):
        return ["ref", v.entry, v.out_idx]
    if isinstance(v, FeedRef):
        return ["fref", v.entry, v.arg_pos]
    if isinstance(v, VarRef):
        return ["vref", v.var_id]
    if isinstance(v, Const):
        return ["c", encode(v.value)]
    if isinstance(v, FoldedConst):
        return ["fc"] + _enc_array(v.value)
    if isinstance(v, slice):
        return ["sl", encode(v.start), encode(v.stop), encode(v.step)]
    if v is Ellipsis:
        return ["e"]
    if isinstance(v, np.dtype):
        return ["dt", str(v)]
    if isinstance(v, torch.dtype):
        return ["tdt", dtype_name(v)]
    if isinstance(v, np.generic):
        return ["np", str(v.dtype), v.item()]
    if isinstance(v, np.ndarray):
        return ["nda"] + _enc_array(v)
    raise CodecError(f"unencodable value of type {type(v).__name__}")


_SIMPLE = {"b": bool, "i": int, "f": float, "s": str}


def _torch_dtype(name) -> torch.dtype:
    """The ``torch.dtype`` a persisted short name denotes; strict: only
    names torch itself defines (never an attribute lookup on anything
    else)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise CodecError(f"unknown dtype {name!r}")
    return dt


def decode(e):
    """Strict inverse of :func:`encode`."""
    if not isinstance(e, list) or not e:
        raise CodecError(f"malformed encoding {e!r}")
    tag = e[0]
    try:
        if tag == "n":
            return None
        if tag in _SIMPLE:
            return _SIMPLE[tag](e[1])
        if tag == "t":
            return tuple(decode(x) for x in e[1])
        if tag == "l":
            return [decode(x) for x in e[1]]
        if tag == "set":
            return {decode(x) for x in e[1]}
        if tag == "d":
            return {decode(k): decode(x) for k, x in e[1]}
        if tag == "aval":
            return Aval(tuple(e[1]), _torch_dtype(e[2]))
        if tag == "ref":
            return Ref(int(e[1]), int(e[2]))
        if tag == "fref":
            return FeedRef(int(e[1]), int(e[2]))
        if tag == "vref":
            return VarRef(int(e[1]))
        if tag == "c":
            return Const(decode(e[1]))
        if tag == "fc":
            return FoldedConst(_dec_array(e[1], e[2], e[3]))
        if tag == "sl":
            return slice(decode(e[1]), decode(e[2]), decode(e[3]))
        if tag == "e":
            return Ellipsis
        if tag == "dt":
            return np.dtype(e[1])
        if tag == "tdt":
            return _torch_dtype(e[1])
        if tag == "np":
            return np.dtype(e[1]).type(e[2])
        if tag == "nda":
            return _dec_array(e[1], e[2], e[3])
    except CodecError:
        raise
    except Exception as exc:
        raise CodecError(f"bad {tag!r} payload: {exc}") from None
    raise CodecError(f"unknown tag {tag!r}")


def _check_keys(d: dict, required: Tuple[str, ...],
                optional: Tuple[str, ...] = ()) -> None:
    extra = set(d) - set(required) - set(optional)
    missing = set(required) - set(d)
    if extra or missing:
        raise CodecError(f"extra fields {sorted(extra)}, "
                         f"missing fields {sorted(missing)}")


# -- TraceEntry / LoopBody / TGNode / TraceGraph ----------------------------

def entry_to_dict(e: TraceEntry) -> dict:
    d = {"op": e.op_name, "attrs": encode(e.attrs),
         "loc": [e.location[0], e.location[1]],
         "irefs": encode(e.input_refs), "avals": encode(e.out_avals),
         "favals": encode(e.feed_avals)}
    sl = getattr(e, "srcs_local", None)
    if sl is not None:
        d["slocal"] = encode(sl)
    return d


def entry_from_dict(d: dict) -> TraceEntry:
    _check_keys(d, ("op", "attrs", "loc", "irefs", "avals", "favals"),
                ("slocal",))
    e = TraceEntry(op_name=str(d["op"]), attrs=decode(d["attrs"]),
                   location=(str(d["loc"][0]), int(d["loc"][1])),
                   input_refs=decode(d["irefs"]),
                   out_avals=decode(d["avals"]),
                   feed_avals=decode(d["favals"]))
    if "slocal" in d:
        e.srcs_local = decode(d["slocal"])
    return e


def body_to_dict(b: LoopBody) -> dict:
    return {"entries": [entry_to_dict(e) for e in b.entries],
            "carries": encode(tuple(b.carries)),
            "invariants": encode(tuple(b.invariants)),
            "var_binds": encode(b.var_binds)}


def body_from_dict(d: dict) -> LoopBody:
    _check_keys(d, ("entries", "carries", "invariants", "var_binds"))
    return LoopBody(entries=[entry_from_dict(x) for x in d["entries"]],
                    carries=[tuple(c) for c in decode(d["carries"])],
                    invariants=list(decode(d["invariants"])),
                    var_binds=dict(decode(d["var_binds"])))


def node_to_dict(n: TGNode) -> dict:
    d = {"uid": n.uid, "kind": n.kind, "op": n.op_name,
         "attrs": encode(n.attrs), "loc": [n.location[0], n.location[1]],
         "srcs": encode(n.srcs), "avals": encode(n.out_avals),
         "children": list(n.children), "fetch": sorted(n.fetch_idxs),
         "sync": n.sync_after, "assigns": encode(n.var_assigns),
         "trips": sorted(n.trips)}
    if n.body is not None:
        d["body"] = body_to_dict(n.body)
        d["lords"] = list(getattr(n, "_last_ordinals", ()))
    return d


def node_from_dict(d: dict) -> TGNode:
    _check_keys(d, ("uid", "kind", "op", "attrs", "loc", "srcs", "avals",
                    "children", "fetch", "sync", "assigns", "trips"),
                ("body", "lords"))
    n = TGNode(int(d["uid"]), str(d["kind"]), op_name=str(d["op"]),
               attrs=decode(d["attrs"]),
               location=(str(d["loc"][0]), int(d["loc"][1])),
               srcs=decode(d["srcs"]), out_avals=decode(d["avals"]),
               children=[int(c) for c in d["children"]],
               fetch_idxs={int(i) for i in d["fetch"]},
               sync_after=bool(d["sync"]), var_assigns=decode(d["assigns"]),
               trips={int(t) for t in d["trips"]})
    if "body" in d:
        n.body = body_from_dict(d["body"])
        lords = tuple(int(o) for o in d.get("lords", ()))
        n._last_ordinals = lords
        n.body.out_slot_for = make_out_slot_for(n.body, lords)
    return n


def tg_to_dict(tg: TraceGraph) -> dict:
    return {"nodes": [node_to_dict(tg.nodes[u]) for u in sorted(tg.nodes)],
            "next_uid": tg._next_uid, "start": tg.start.uid,
            "end": tg.end.uid, "version": tg.version,
            "assigned": sorted(tg.assigned_vars),
            "read": sorted(tg.read_vars)}


def tg_from_dict(d: dict, family_key=None) -> TraceGraph:
    _check_keys(d, ("nodes", "next_uid", "start", "end", "version",
                    "assigned", "read"))
    g = TraceGraph.__new__(TraceGraph)
    g.family_key = family_key
    g.nodes = {}
    for nd in d["nodes"]:
        n = node_from_dict(nd)
        g.nodes[n.uid] = n
    g._next_uid = int(d["next_uid"])
    g.start = g.nodes[int(d["start"])]
    g.end = g.nodes[int(d["end"])]
    g.version = int(d["version"])
    g.assigned_vars = {int(v) for v in d["assigned"]}
    g.read_vars = {int(v) for v in d["read"]}
    return g


# -- observation records -----------------------------------------------------

def feed_obs_to_dict(fo: FeedObservations) -> dict:
    slots = []
    for k in sorted(fo.slots):
        v = fo.slots[k]
        slots.append([list(k), None if v is _VARYING
                      else [_enc_array(v[0]), int(v[1])]])
    return {"version": fo.version, "slots": slots}


def feed_obs_from_dict(d: dict) -> FeedObservations:
    _check_keys(d, ("version", "slots"))
    fo = FeedObservations()
    fo.version = int(d["version"])
    for k, v in d["slots"]:
        key = (int(k[0]), int(k[1]))
        fo.slots[key] = _VARYING if v is None else (
            _dec_array(*v[0]), int(v[1]))
    return fo


def fetch_obs_to_dict(fo: FetchObservations) -> dict:
    ra = [[list(k),
           sorted(fo.read_after[k], key=lambda u: -1 if u is None else u)]
          for k in sorted(fo.read_after)]
    return {"version": fo.version, "read_after": ra}


def fetch_obs_from_dict(d: dict) -> FetchObservations:
    _check_keys(d, ("version", "read_after"))
    fo = FetchObservations()
    fo.version = int(d["version"])
    for k, pts in d["read_after"]:
        fo.read_after[(int(k[0]), int(k[1]))] = {
            None if p is None else int(p) for p in pts}
    return fo


# -- family records -----------------------------------------------------------

def family_record(tg, feed_obs, fetch_obs, feed_sig, var_avals,
                  tombstones, pipeline) -> dict:
    """Everything needed to hydrate a family in a fresh process.  The
    pass pipeline is recorded for inspection only — hydration replays
    ``run_passes`` with the *current* engine pipeline, because the
    observations are pipeline-independent facts about the program."""
    return {"fmt": FORMAT,
            "feed_sig": encode(feed_sig),
            "tg": tg_to_dict(tg),
            "feed_obs": feed_obs_to_dict(feed_obs),
            "fetch_obs": fetch_obs_to_dict(fetch_obs),
            "var_avals": [[int(vid), [list(a.shape), dtype_name(a.dtype)]]
                          for vid, a in sorted(var_avals.items())],
            "tombstones": [[int(vid), [list(s), dtype_name(dt)]]
                           for vid, (s, dt) in sorted(tombstones.items())],
            "pipeline": list(pipeline)}


class FamilyRecord:
    __slots__ = ("feed_sig", "tg", "feed_obs", "fetch_obs", "var_avals",
                 "tombstones", "pipeline")


def parse_family_record(doc: dict) -> FamilyRecord:
    if not isinstance(doc, dict) or doc.get("fmt") != FORMAT:
        raise CodecError(f"unsupported family record {type(doc).__name__}")
    _check_keys(doc, ("fmt", "feed_sig", "tg", "feed_obs", "fetch_obs",
                      "var_avals", "tombstones", "pipeline"))
    rec = FamilyRecord()
    rec.feed_sig = decode(doc["feed_sig"])
    rec.tg = tg_from_dict(doc["tg"])
    rec.feed_obs = feed_obs_from_dict(doc["feed_obs"])
    rec.fetch_obs = fetch_obs_from_dict(doc["fetch_obs"])
    rec.var_avals = {int(vid): Aval(tuple(a[0]), _torch_dtype(a[1]))
                     for vid, a in doc["var_avals"]}
    rec.tombstones = {int(vid): (tuple(s[0]), _torch_dtype(s[1]))
                      for vid, s in doc["tombstones"]}
    rec.pipeline = tuple(str(p) for p in doc["pipeline"])
    return rec


def collect_var_ids(tg: TraceGraph) -> Set[int]:
    """Every variable id the graph reads or writes — the coverage set a
    family record must describe (live avals or tombstones) to be saved."""
    out: Set[int] = set()
    for n in tg.nodes.values():
        for s in n.srcs:
            if s and s[0] == "var":
                out.add(s[1])
        for vid, _ in n.var_assigns:
            out.add(vid)
        if n.body is not None:
            out.update(n.body.var_binds)
            for e in n.body.entries:
                for s in getattr(e, "srcs_local", ()):
                    if s and s[0] == "var":
                        out.add(s[1])
    return out
