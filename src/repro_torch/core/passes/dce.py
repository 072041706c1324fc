"""Dead-op elimination (pipeline stage ``dce``, DESIGN.md §10).

A node is dead when nothing observable depends on it: its outputs are
never fetch-annotated, never bound to a framework Variable (directly or
through a rolled loop's ``var_binds``), and not consumed — transitively —
by any node that is.  Dead nodes stay in the cloned graph's CFG (so fork
children orders, the Case Select mapping and the Walker's validation path
are untouched) but graphgen skips their computation entirely and the
segment IO analysis ignores their sources, so their inputs stop being
carried across segments.

Legality notes:

* fetch annotations and variable writes are liveness **roots** — the pass
  can never remove them by construction;
* a CSE alias node (cse.py) is live iff it has fetch/var annotations; its
  effective source is its representative, which liveness follows;
* liveness is computed on effective (post-CSE) sources, so a value whose
  only consumers were rewritten away dies here — the canonical
  fold→cse→dce ordering.
"""

from __future__ import annotations

from repro_torch.core.passes.analysis import live_uids


def run(ctx) -> None:
    otg, opt = ctx.otg, ctx.opt
    live = live_uids(otg, opt)
    eliminated = 0
    for uid, n in otg.nodes.items():
        if n.kind not in ("op", "loop"):
            continue
        if uid in live or uid in opt.dead:
            continue
        opt.dead.add(uid)
        opt.alias_nodes.pop(uid, None)
        eliminated += 1
    if eliminated:
        opt.bump("nodes_eliminated", eliminated)
