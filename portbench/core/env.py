"""The process environment of one run, set before torch is imported.

Every build and kernel cache of the program goes to a fixed directory
inside the checkout (``.portbench_cache/``), so only the first run of a
checkout builds; the hand-written kernels build into
``src/repro_torch/kernels/_build/``, also inside it.  The warm-boot store
(``TERRA_CACHE_DIR``) is switched off, so every run does the same set-up
work from its seed.  ``USE_FLAX=0`` and ``USE_JAX=0`` keep libraries that
look for JAX from loading it."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(ROOT, "src")
CACHE = os.path.join(ROOT, ".portbench_cache")

# top-level module names that nothing the benchmark runs may load: JAX,
# its libraries, and the JAX package the port was made from (compared as
# whole names: ``repro_torch`` is the port and is allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("TERRA_CACHE_DIR", None)
    os.environ.pop("TERRA_OPTIMIZE", None)
    for p in (SRC, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_loaded(modules=None) -> list:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".", 1)[0] in FORBIDDEN)
