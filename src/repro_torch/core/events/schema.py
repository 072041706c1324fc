"""Event (de)serialization + JSONL trace validation.

The wire format is one flat JSON object per event: ``type`` (the class
name in ``EVENT_TYPES``), ``ts`` (the stream clock stamp), and the
dataclass fields.  ``from_dict`` is strict — an unknown type, a missing
field or an unexpected field is a schema violation — so the CI step that
validates the bench's exported ``trace.jsonl`` actually proves the
artifact parses back into the typed event set (DESIGN.md §13)."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

from repro_torch.core.events.types import EVENT_TYPES


def _plain(v):
    # most event fields are already JSON-native: test those first so the
    # per-event serialization cost (the ≤2 % tracing-overhead budget)
    # stays a few isinstance checks, not reflection
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if hasattr(v, "item") and not isinstance(v, bytes):
        try:
            return v.item()         # numpy scalar -> Python scalar
        except Exception:
            return repr(v)
    return repr(v)


# field-name tuples cached per event class: dataclasses.fields() is
# reflection-heavy and event_to_dict runs once per event on traced runs
_FIELDS: Dict[type, tuple] = {}


def _field_names(cls) -> tuple:
    names = _FIELDS.get(cls)
    if names is None:
        names = tuple(f.name for f in dataclasses.fields(cls))
        _FIELDS[cls] = names
    return names


def event_to_dict(event) -> Dict[str, Any]:
    d = {"type": type(event).__name__, "ts": event.ts}
    for name in _field_names(type(event)):
        d[name] = _plain(getattr(event, name))
    return d


def dict_to_event(d: Dict[str, Any]):
    """Strict inverse of :func:`event_to_dict`; raises ValueError on any
    schema violation."""
    d = dict(d)
    name = d.pop("type", None)
    cls = EVENT_TYPES.get(name)
    if cls is None:
        raise ValueError(f"unknown event type {name!r}")
    ts = d.pop("ts", None)
    names = {f.name for f in dataclasses.fields(cls)}
    required = {f.name for f in dataclasses.fields(cls)
                if f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING}
    extra, missing = set(d) - names, required - set(d)
    if extra or missing:
        raise ValueError(f"{name}: extra fields {sorted(extra)}, "
                         f"missing fields {sorted(missing)}")
    ev = cls(**d)
    ev.ts = ts
    return ev


def load_jsonl(path: str) -> List[Any]:
    """Parse a JSONL trace back into typed events, validating every line."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(dict_to_event(json.loads(line)))
            except ValueError as e:
                raise ValueError(f"{path}:{i}: {e}") from None
    return out


def validate_jsonl(path: str) -> Dict[str, int]:
    """Validate a trace file; returns per-type event counts (the CI
    schema-check step prints these)."""
    counts: Dict[str, int] = {}
    for ev in load_jsonl(path):
        name = type(ev).__name__
        counts[name] = counts.get(name, 0) + 1
    return counts
