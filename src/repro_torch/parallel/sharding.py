"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP), single-device
part.

Model code annotates arrays with *logical* axis names; the reference maps
them to mesh axes via a rule table, MaxText-style.  The port carries the
policy object, the thread-local current policy and ``logical``, which the
trainer and the train step read.  On one device there is no mesh:
``logical`` returns its input, and a policy over a mesh raises
``NotImplementedError`` until the parallel slice (``ROADMAP.md`` Queue 1,
item 8).

Default rules:
    batch       -> ("pod", "data")      # DP across pods and data axis
    fsdp        -> ("data",)            # ZeRO-3 weight shard (+pod optional)
    tp          -> ("model",)           # tensor parallel: heads / ffn hidden
    expert      -> ("model",)           # EP: MoE expert dim
    seq         -> ()                   # sequence kept unsharded by default
    sp          -> ("model",)           # sequence parallel for long-context
    vocab       -> ("model",)
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

_TLS = threading.local()


DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "fsdp_pod": ("pod", "data"),
    "tp": ("model",),
    "expert": ("model",),
    "capacity": ("data",),     # MoE per-expert token slots shard over data
    "seq": (),
    "sp": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "d_model": (),
    "d_ff": ("model",),
    "unsharded": (),
}


class ShardingPolicy:
    """Resolves logical axis names to mesh axes for a given mesh (``None``:
    one device, nothing to resolve)."""

    def __init__(self, mesh=None, rules: Optional[dict] = None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh arrives with the port's parallel slice "
                "(ROADMAP.md Queue 1, item 8)")
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)


def current_policy() -> Optional[ShardingPolicy]:
    return getattr(_TLS, "policy", None)


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    prev = current_policy()
    _TLS.policy = policy
    try:
        yield policy
    finally:
        _TLS.policy = prev


def logical(x, *names: Optional[str]):
    """Annotate activation sharding with logical axis names: on one device
    (no mesh) the identity."""
    pol = current_policy()
    if pol is None or pol.mesh is None:
        return x
    raise NotImplementedError("sharded activations arrive with the port's "
                              "parallel slice (ROADMAP.md Queue 1, item 8)")
