"""Constant-feed folding (pipeline stage ``fold``, DESIGN.md §10).

An Input Feeding slot whose fed Python value was byte-identical across at
least two traced iterations of the covered streak (FeedObservations) is
demoted to a baked constant: the node's ``('feed', aval)`` source is
rewritten to ``('const', FoldedConst(value))``, the slot disappears from
the segment's Input Feeding layout, and the segment reuses one device
copy of the value for everything that depends on it (e.g. a causal-mask
bias recomputed from the same numpy array every step) instead of
receiving it as a feed each call.

Safety — the demotion must be reversible, because "was constant so far"
is not "is constant":

* the walker keeps a per-slot probe (``GraphProgram.folded_feeds``): when
  the skeleton collects a value for a folded slot it compares against the
  baked constant and raises DivergenceError on mismatch, which cancels
  the iteration and re-enters tracing;
* the mismatching observation marks the slot varying (monotone) and bumps
  the observation version, so the next GraphProgram regeneration restores
  the feed — the slot folds at most once per value regime;
* slots above ``MAX_FOLD_BYTES`` or with non-array values never fold
  (the equality probe runs every iteration on the Python thread);
* per-iteration RNG key feeds vary by construction and therefore never
  qualify.
"""

from __future__ import annotations

from repro_torch.core.passes.analysis import FoldedConst


def run(ctx) -> None:
    otg, opt, obs = ctx.otg, ctx.opt, ctx.feed_obs
    folded = 0
    for uid, n in otg.nodes.items():
        if n.kind != "op" or uid in opt.dead:
            continue
        if not any(s[0] == "feed" for s in n.srcs):
            continue
        new_srcs = list(n.srcs)
        changed = False
        for pos, s in enumerate(n.srcs):
            if s[0] != "feed":
                continue
            value = obs.stable_value((uid, pos))
            if value is None:
                continue
            fc = FoldedConst(value)
            new_srcs[pos] = ("const", fc)
            opt.folded[(uid, pos)] = fc
            folded += 1
            changed = True
        if changed:
            n.srcs = tuple(new_srcs)
            n._sig_cache = None
    if folded:
        opt.bump("feeds_folded", folded)
