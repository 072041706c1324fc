"""Ahead-of-time segment artifacts: the port's counterpart of serialized
executables (DESIGN.md §14).

The reference serializes each segment's compiled XLA executable.  Neither
what a segment compiles to here — a Python closure over the GraphProgram,
wrapped on a card in a :class:`~repro_torch.core.capture.CapturedFn` —
nor a CUDA graph can be serialized.  What a warm process can skip is the
segment's compile-time analyses, so the artifact holds what
``GraphProgram._segment_fn`` needs beyond the hydrated graph
(:class:`~repro_torch.core.graphgen.SegmentBuild`: the item list, the
liveness, capturability and the host slots) and the segment's donation
plan, encoded with the strict codec as JSON.  Node ids are written in the
segment's canonical ids (``segment_signature``'s remap), because two
families whose segments share a signature number their nodes differently.

A warm process decodes the artifact, checks its donation plan and IO
contract against the segment's, maps the ids back and builds the callable
from it without rerunning the analyses.  On a card the callable is a fresh
``CapturedFn``: its first call runs eager on the side stream and its
second call captures the CUDA graph anew (``engine.capture.stats``).
Nothing here calls ``torch.compile`` or ``torch.export``, and nothing is
unpickled.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.casing import NodeItem, SwitchItem
from repro_torch.core.graphgen import SegmentBuild
from repro_torch.core.persist import codec

FORMAT = 1


def _enc_items(items, C) -> list:
    out = []
    for it in items:
        if isinstance(it, NodeItem):
            out.append(["N", C(it.uid)])
        elif isinstance(it, SwitchItem):
            out.append(["S", C(it.fork_uid),
                        [_enc_items(b, C) for b in it.branches],
                        C(it.join_uid), [C(u) for u in it.child_order]])
        else:
            raise codec.CodecError(f"unknown item {it!r}")
    return out


def _dec_items(enc, L) -> list:
    out = []
    for e in enc:
        if e[0] == "N" and len(e) == 2:
            out.append(NodeItem(L(e[1])))
        elif e[0] == "S" and len(e) == 5:
            out.append(SwitchItem(L(e[1]), [_dec_items(b, L) for b in e[2]],
                                  L(e[3]), tuple(L(u) for u in e[4])))
        else:
            raise codec.CodecError(f"bad segment item {e!r}")
    return out


def _contract(sp, C) -> Dict[str, Any]:
    """The segment's donation plan and IO layout, in canonical ids."""
    def keys(ks):
        return [[C(u), int(oi)] for u, oi in ks]
    return {"don": list(sp.don_var_ids), "keep": list(sp.keep_var_ids),
            "owned": list(sp.owned_writes), "writes": list(sp.var_writes),
            "carries_in": keys(sp.carries_in),
            "carries_out": keys(sp.carries_out),
            "fetch": keys(sp.fetch_keys),
            "feeds": [[C(u), int(pos)] for u, pos, _ in sp.feed_keys]}


def segment_artifact(gp, sp, build: SegmentBuild) -> Dict[str, Any]:
    """The JSON document persisted for one compiled segment."""
    canon = sp.canon

    def C(uid: int) -> int:
        c = canon.get(uid)
        if c is None:
            raise codec.CodecError(f"uid {uid} outside the signature")
        return c
    return {"fmt": FORMAT,
            "items": _enc_items(build.items, C),
            "frees": [[[C(u), int(oi)] for u, oi in f] for f in build.frees],
            "capturable": bool(build.capturable),
            "sel_slots": list(build.sel_slots),
            "trip_slots": list(build.trip_slots),
            "contract": _contract(sp, C)}


def load_build(gp, sp, doc) -> SegmentBuild:
    """Decode an artifact into the segment's :class:`SegmentBuild`.
    Raises :class:`codec.CodecError` on any mismatch with the segment —
    the caller deletes such an artifact and compiles."""
    if not isinstance(doc, dict) or doc.get("fmt") != FORMAT:
        raise codec.CodecError("unsupported segment artifact")
    codec._check_keys(doc, ("fmt", "items", "frees", "capturable",
                            "sel_slots", "trip_slots", "contract"))
    local = {c: u for u, c in sp.canon.items()}

    def L(c) -> int:
        u = local.get(int(c))
        if u is None:
            raise codec.CodecError(f"canonical id {c} outside the segment")
        return u
    if doc["contract"] != _contract(sp, sp.canon.__getitem__):
        raise codec.CodecError("segment contract differs from the artifact")
    try:
        items = _dec_items(doc["items"], L)
        frees = tuple(tuple((L(u), int(oi)) for u, oi in f)
                      for f in doc["frees"])
        if len(frees) != len(items):
            raise codec.CodecError("liveness does not match the items")
        return SegmentBuild(items, frees, bool(doc["capturable"]),
                            tuple(int(j) for j in doc["sel_slots"]),
                            tuple(int(j) for j in doc["trip_slots"]))
    except codec.CodecError:
        raise
    except Exception as exc:
        raise codec.CodecError(f"bad segment artifact: {exc}") from None
