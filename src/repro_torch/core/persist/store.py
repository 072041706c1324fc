"""Content-addressed on-disk artifact store (DESIGN.md §14).

Layout: ``<root>/<namespace>/<relpath>`` where ``namespace`` comes from
keys.namespace() (torch version + CUDA or CPU + code digest).  Writes are
atomic (temp file + ``os.replace``) so a concurrent reader sees either
the old artifact or the new one, never a torn file; reads return None on
ANY failure — a missing, truncated or unparsable artifact is always a
clean cache miss."""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional


class ArtifactStore:
    def __init__(self, root: str, namespace: str):
        self.root = root
        self.base = os.path.join(root, namespace)

    def path(self, rel: str) -> str:
        return os.path.join(self.base, rel)

    # -- writes (atomic; failures degrade to 'not persisted') --------------
    def write_bytes(self, rel: str, data: bytes) -> int:
        """Write atomically; returns bytes written (0 on failure)."""
        path = self.path(rel)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
            return len(data)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return 0

    def write_json(self, rel: str, doc: Any) -> int:
        try:
            data = json.dumps(doc, separators=(",", ":")).encode("utf-8")
        except (TypeError, ValueError):
            return 0
        return self.write_bytes(rel, data)

    # -- reads (any failure is a miss) --------------------------------------
    def read_bytes(self, rel: str) -> Optional[bytes]:
        try:
            with open(self.path(rel), "rb") as f:
                return f.read()
        except OSError:
            return None

    def read_json(self, rel: str) -> Optional[Any]:
        data = self.read_bytes(rel)
        if data is None:
            return None
        try:
            return json.loads(data.decode("utf-8"))
        except Exception:
            return None

    def delete(self, rel: str) -> None:
        try:
            os.remove(self.path(rel))
        except OSError:
            pass

    def list(self, reldir: str) -> List[str]:
        """Artifact names under a relative directory, newest first (the
        hydration order: most recently written candidate wins)."""
        base = self.path(reldir)
        try:
            names = [n for n in os.listdir(base) if ".tmp" not in n]
        except OSError:
            return []

        def mtime(n: str) -> float:
            try:
                return os.path.getmtime(os.path.join(base, n))
            except OSError:
                return 0.0
        return sorted(names, key=mtime, reverse=True)
