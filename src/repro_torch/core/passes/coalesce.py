"""Segment coalescing (pipeline stage ``coalesce``, DESIGN.md §10).

Every gating fetch cuts a segment (DESIGN.md §2) so Python can obtain the
value without waiting for downstream graph work — but the cut is only
*useful* when Python actually blocks on the value before the downstream
work is dispatched.  A program that fetches for logging or metrics and
reads the values late (or only after the iteration closes) pays one
dispatch per boundary for nothing.

The pass removes a boundary when the fetch-timing observations
(analysis.FetchObservations, recorded across traced iterations) prove the
late-read pattern: every fetch key of the segments merged so far was only
ever materialized at-or-after the node that ends the *following* segment.
Under that condition the merged segment has already been dispatched by
the time Python asks, so the read hits a completed future exactly as
before — with strictly fewer dispatches per iteration.  If steady-state
Python ever reads earlier than the traces promised, the read falls back
to path-specialized chain dispatch (dispatch.py): slower, never wrong.

Merging into the trailing region (no later gating node) requires the keys
to have *no* observed mid-iteration read at all, since the final segment
only dispatches at iteration end.  The always-empty trailing segment the
segmenter appends after a program-final boundary is dropped
unconditionally — it computes nothing and fetches nothing.

Values crossing a removed boundary become segment-internal dataflow
instead of explicit carries; variable reads keep their meaning because a
``VarRef`` read can only precede the first write of that variable on any
validated path (trace.py), so no read inside the merged region can
observe an intra-region write.
"""

from __future__ import annotations

from repro_torch.core.casing import NodeItem
from repro_torch.core.passes.analysis import region_info


def run(ctx) -> None:
    otg, opt, obs = ctx.otg, ctx.opt, ctx.fetch_obs
    structure = ctx.structure
    info = region_info(structure)
    segments = structure.segments
    if segments and not segments[-1]:
        opt.drop_empty_trailing = True
        segments = segments[:-1]
    if len(segments) < 2:
        if opt.drop_empty_trailing:
            opt.bump("segments_coalesced")
            ctx.invalidate_structure()
        return

    def seg_fetch_keys(seg):
        keys = []
        for uid in structure.uids_in(seg):
            n = otg.nodes[uid]
            if uid in opt.dead:
                continue
            for oi in sorted(n.fetch_idxs):
                keys.append((uid, oi))
        return keys

    def end_uid(seg):
        for item in reversed(seg):
            if isinstance(item, NodeItem):
                return item.uid
        return None

    coalesced = 0
    group_keys = seg_fetch_keys(segments[0])
    for si in range(len(segments) - 1):
        nxt = segments[si + 1]
        boundary = end_uid(segments[si])
        e = end_uid(nxt)
        # the merged group would dispatch at the following segment's own
        # gating node; a following segment WITHOUT one (the true trailing
        # region) only dispatches at iteration end, so merging into it
        # requires the keys to have no mid-iteration read at all
        gated_end = e is not None and otg.nodes[e].sync_after
        ok = boundary is not None
        for key in group_keys:
            pos = obs.earliest_read_pos(key, info.flatpos)
            if pos is None:
                continue            # never read mid-iteration
            if not gated_end or pos < info.flatpos.get(e, -1):
                ok = False
                break
        if ok:
            otg.nodes[boundary].sync_after = False
            coalesced += 1
            group_keys += seg_fetch_keys(nxt)
        else:
            group_keys = seg_fetch_keys(nxt)
    if coalesced or opt.drop_empty_trailing:
        opt.bump("segments_coalesced",
                 coalesced + (1 if opt.drop_empty_trailing else 0))
        ctx.invalidate_structure()
