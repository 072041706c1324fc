"""Common-subexpression elimination (pipeline stage ``cse``, DESIGN.md §10).

``merge_trace`` already dedups nodes whose full ``sig()`` — including the
program location — matches, so the duplicates left for this pass are ops
that compute the same value *from different source lines*: the same
expression in two tape regions (GAN-style double forward), a hand-inlined
recomputation, or the same subexpression in sibling switch branches.  The
CSE key is therefore ``sig()`` minus location: (op, attrs, sources).

Two mechanisms, both CFG-shape-preserving for the Walker:

* **Dominating reuse** — a duplicate whose earliest occurrence executes on
  every path through it (its region path is a prefix of the duplicate's,
  and it comes earlier in flat program order) is merged: every consumer's
  source is rewritten to the representative, and the duplicate either
  becomes an *alias node* (it still carries fetch/Variable annotations —
  graphgen binds its outputs from the representative's values) or is
  marked dead outright.
* **Branch hoisting** — a key that appears in two or more sibling branches
  of one switch region, with every source *strictly dominating* the fork
  (variable reads and constants always qualify; node sources must come
  earlier at an enclosing level), is hoisted: a fresh node is spliced
  into the CFG just before the fork (the optimized graph only; the
  Walker never sees it) and all branch occurrences are merged into it.
  Nothing below the pass merges work across branches.  A
  duplicate consuming the fork node's *own* output is left alone —
  splicing after the fork would re-root the switch region and break the
  Case Select slot keying.

Hard exclusions: nodes with Input Feeding sources never merge — two feed
slots with equal avals are *different values* (per-iteration RNG keys are
the canonical example) — and rolled-loop nodes are left alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.casing import SwitchItem
from repro_torch.core.passes.analysis import region_info
from repro_torch.core.tracegraph import TGNode

Key = Tuple[int, int]


def _eligible(n, opt) -> bool:
    return (n.kind == "op" and n.uid not in opt.dead
            and n.uid not in opt.alias_nodes
            and not any(s[0] == "feed" for s in n.srcs))


def _cse_key(n) -> Optional[Tuple]:
    key = (n.op_name, n.attrs, n.srcs)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _dominates(rep_uid: int, dup_uid: int, info) -> bool:
    rp, dp = info.path.get(rep_uid), info.path.get(dup_uid)
    if rp is None or dp is None:
        return False
    return (dp[:len(rp)] == rp
            and info.flatpos[rep_uid] < info.flatpos[dup_uid])


def _merge(rep: TGNode, dup: TGNode, opt, rewrites: Dict[Key, Key]) -> None:
    for oi in range(len(dup.out_avals)):
        rewrites[(dup.uid, oi)] = (rep.uid, oi)
    if dup.fetch_idxs or dup.var_assigns:
        opt.alias_nodes[dup.uid] = tuple(
            (rep.uid, oi) for oi in range(len(dup.out_avals)))
    else:
        opt.dead.add(dup.uid)


def _apply_rewrites(otg, rewrites: Dict[Key, Key]) -> None:
    if not rewrites:
        return

    def R(key: Key) -> Key:          # path compression over merge rounds
        while key in rewrites:
            key = rewrites[key]
        return key

    for n in otg.nodes.values():
        if n.kind not in ("op", "loop") or not n.srcs:
            continue
        new = tuple(("node",) + R((s[1], s[2])) if s[0] == "node" else s
                    for s in n.srcs)
        if new != n.srcs:
            n.srcs = new
            n._sig_cache = None


def run(ctx) -> None:
    otg, opt = ctx.otg, ctx.opt
    info = region_info(ctx.structure)
    rewrites: Dict[Key, Key] = {}
    hits = 0

    # -- dominating reuse, to fixpoint (merges can expose new duplicates) --
    changed = True
    while changed:
        changed = False
        groups: Dict[Tuple, List[TGNode]] = {}
        for n in otg.nodes.values():
            if _eligible(n, opt):
                key = _cse_key(n)
                if key is not None:
                    groups.setdefault(key, []).append(n)
        round_rw: Dict[Key, Key] = {}
        for nodes in groups.values():
            if len(nodes) < 2:
                continue
            nodes.sort(key=lambda n: info.flatpos.get(n.uid, 1 << 30))
            rep = nodes[0]
            for dup in nodes[1:]:
                if dup.out_avals != rep.out_avals:
                    continue
                if _dominates(rep.uid, dup.uid, info):
                    _merge(rep, dup, opt, round_rw)
                    hits += 1
                    changed = True
        rewrites.update(round_rw)
        _apply_rewrites(otg, round_rw)

    # -- branch hoisting ---------------------------------------------------
    structure = ctx.structure
    fork_pos, spliced = info.flatpos, False
    for item in structure.iter_items():
        if not isinstance(item, SwitchItem):
            continue
        fuid = item.fork_uid
        groups: Dict[Tuple, List[Tuple[int, TGNode]]] = {}
        for bi, branch in enumerate(item.branches):
            for uid in structure.uids_in(branch):
                n = otg.nodes[uid]
                if not _eligible(n, opt):
                    continue
                if not all(s[0] != "node"
                           or _dominates(s[1], fuid, info)
                           for s in n.srcs):
                    continue        # a source lives inside a branch
                key = _cse_key(n)
                if key is not None:
                    groups.setdefault(key, []).append((bi, n))
        round_rw: Dict[Key, Key] = {}
        for occurrences in groups.values():
            if len({bi for bi, _ in occurrences}) < 2:
                continue            # one branch only: no cross-branch win
            first = occurrences[0][1]
            host = otg.splice_before(fuid, TGNode(
                0, "op", op_name=first.op_name, attrs=first.attrs,
                location=first.location, srcs=first.srcs,
                out_avals=first.out_avals))
            spliced = True
            for _, dup in occurrences:
                _merge(host, dup, opt, round_rw)
                hits += 1
        rewrites.update(round_rw)
        _apply_rewrites(otg, round_rw)
    if spliced:
        ctx.invalidate_structure()

    # canonicalize alias targets: a representative merged away in a later
    # round (or hoisted) must not leave aliases pointing at a dead node
    if rewrites and opt.alias_nodes:
        def R(key: Key) -> Key:
            while key in rewrites:
                key = rewrites[key]
            return key
        for uid, keys in list(opt.alias_nodes.items()):
            opt.alias_nodes[uid] = tuple(R(k) for k in keys)
    if hits:
        opt.bump("cse_hits", hits)
