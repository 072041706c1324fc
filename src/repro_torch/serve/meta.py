"""Out-of-band static-metadata registry for serving DL ops.

Ops cross the Terra boundary with flat tensor leaves and *hashable*
attributes (node identity, Appendix A); pytree treedefs, step closures
and scatter-axis tables are static per driver but not hashable, so they
live here keyed by an integer id that IS an op attribute.  Entries are
tiny (treedefs + callables) and live for the process: retired drivers'
decode nodes survive in their TraceGraph families as dead branches and
must still resolve their meta id when those graphs regenerate.
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class MetaRegistry:
    def __init__(self):
        self._entries: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._next = 0

    def register(self, entry: Any) -> int:
        with self._lock:
            mid = self._next
            self._next += 1
            self._entries[mid] = entry
        return mid

    def get(self, mid: int) -> Any:
        return self._entries[mid]
