"""Cache-key discipline for the artifact store (DESIGN.md §14).

Nothing derived from Python's process-salted ``hash()`` (entry stamps,
``avals_digest``, ``FoldedConst._key``) ever reaches disk: on-disk keys
are sha256 digests of the canonical JSON form produced by codec.py.  The
store namespace folds in the torch version, the engine's device kind (the
CUDA toolkit torch was built with, or the CPU) and a digest of the
package's sources (every ``.py`` file and the kernels' ``.cu`` sources),
so upgrading torch, switching device or editing the engine makes every
prior artifact a clean miss — never a wrong load.
``$TERRA_CACHE_SALT`` is appended to the namespace when set (the tests'
version-skew lever; also handy for manual cache busting)."""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Optional

import torch

from repro_torch.core.persist import codec


def canonical_json(v) -> str:
    """Deterministic JSON for any codec-encodable value; raises
    :class:`codec.CodecError` otherwise."""
    return json.dumps(codec.encode(v), sort_keys=True,
                      separators=(",", ":"))


def digest_of(v) -> Optional[str]:
    """sha256 digest of a value's canonical form, or None when the value
    is not encodable (callers treat None as 'not persistable')."""
    try:
        s = canonical_json(v)
    except codec.CodecError:
        return None
    return hashlib.sha256(s.encode("utf-8")).hexdigest()[:24]


_SKIP_DIRS = ("_build", "__pycache__")     # build outputs, bytecode


@functools.lru_cache(maxsize=1)
def code_digest() -> str:
    """Digest of every .py file under the repro_torch package and of the
    kernels' CUDA sources — any source edit invalidates the whole cache
    namespace.  Built libraries and bytecode are left out, so building
    the kernels between two runs keeps the namespace."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    h = hashlib.sha256()
    paths = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for fn in filenames:
            if fn.endswith(".py") or fn.endswith(".cu"):
                paths.append(os.path.join(dirpath, fn))
    for p in sorted(paths):
        h.update(os.path.relpath(p, root).encode("utf-8"))
        try:
            with open(p, "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"<unreadable>")
    return h.hexdigest()[:16]


def device_kind(device: torch.device) -> str:
    """``cuda<major><minor>`` (the toolkit torch was built with) for a
    card, ``cpu`` for the CPU."""
    if device.type == "cuda":
        return "cuda" + (torch.version.cuda or "").replace(".", "")
    return device.type


def namespace(device: torch.device) -> str:
    """Versioned manifest key: the store root subdirectory all artifacts
    of this (torch version, device kind, code) combination live under."""
    ns = (f"torch{torch.__version__}-{device_kind(device)}"
          f"-code{code_digest()}")
    salt = os.environ.get("TERRA_CACHE_SALT", "")
    if salt:
        ns += f"-{salt}"
    return ns


def family_dir(scope: str, feed_sig) -> Optional[str]:
    """Relative directory holding all candidate records for one
    (function scope, feed signature) pair; sibling var-aval classes are
    sibling files inside it."""
    d = digest_of(("family", scope, feed_sig))
    return None if d is None else f"fam/{d}"


def record_name(var_avals: dict) -> Optional[str]:
    d = digest_of(("vars", tuple(sorted(var_avals.items()))))
    return None if d is None else f"{d}.json"


def segment_rel(signature, var_avals_of_reads) -> Optional[str]:
    """Relative path of a segment's AOT artifact (aot.py).  The structural
    signature does not capture variable avals (var_reads are raw ids), so
    they are folded in here — two families sharing a signature but
    differing in buffer shapes must not share an executable."""
    d = digest_of(("segment", signature, var_avals_of_reads))
    return None if d is None else f"seg/{d}.json"
