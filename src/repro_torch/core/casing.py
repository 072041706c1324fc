"""Case assignment: structuring the TraceGraph into switch regions.

This is the paper's *case assignment algorithm* (§4.2 / Appendix B): given
the TraceGraph DAG, find the *Switch-Case* regions so that the generated
symbolic graph executes exactly the operations of whichever trace the
PythonRunner follows, with a *Case Select* input per fork.

We structure the DAG with immediate post-dominators: for a fork node F, the
region spans F's children up to ipostdom(F) (the join).  Because every trace
terminates at the unique END node, ipostdom is total, and because node
equality includes input sources (tracegraph.py), any node after the join
consumes only path-independent values — the only per-path state is variable
bindings and interior fetches, which become the switch outputs (phi slots).

The result is a structured program:
    Program = [Item ...]
    Item    = NodeItem(uid) | SwitchItem(fork_uid, branches=[Program...],
              join_uid) | (loop nodes are NodeItems — their body is handled
              by graphgen)
plus the *segments* partition: the top-level program is cut after every node
whose fetch gates the PythonRunner (sync_after), giving the co-execution
segment boundaries (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.tracegraph import TraceGraph


@dataclasses.dataclass
class NodeItem:
    uid: int


@dataclasses.dataclass
class SwitchItem:
    fork_uid: int
    branches: List[list]
    join_uid: int
    # child uid order defining the Case Select index — the PythonRunner
    # selects the branch whose first node matches the op it executes
    child_order: Tuple[int, ...] = ()


def _postorder(succ: Dict[int, List[int]], root: int) -> List[int]:
    """Iterative DFS postorder of the nodes reachable from ``root``."""
    seen, order, stack = {root}, [], [(root, iter(succ.get(root, ())))]
    while stack:
        node, it = stack[-1]
        nxt = next(it, None)
        if nxt is None:
            stack.pop()
            order.append(node)
        elif nxt not in seen:
            seen.add(nxt)
            stack.append((nxt, iter(succ.get(nxt, ()))))
    return order


def immediate_dominators(succ: Dict[int, List[int]], root: int
                         ) -> Dict[int, int]:
    """Immediate dominators of the nodes reachable from ``root``
    (Cooper, Harvey and Kennedy's iterative algorithm); ``root`` maps to
    itself."""
    order = _postorder(succ, root)
    index = {n: i for i, n in enumerate(order)}
    preds: Dict[int, List[int]] = {n: [] for n in order}
    for n in order:
        for c in succ.get(n, ()):
            preds[c].append(n)
    idom = {root: root}

    def intersect(a: int, b: int) -> int:
        while a != b:
            while index[a] < index[b]:
                a = idom[a]
            while index[b] < index[a]:
                b = idom[b]
        return a

    changed = True
    while changed:
        changed = False
        for n in reversed(order):
            if n == root:
                continue
            done = [p for p in preds[n] if p in idom]
            new = done[0]
            for p in done[1:]:
                new = intersect(p, new)
            if idom.get(n) != new:
                idom[n] = new
                changed = True
    return idom


def _is_dag(succ: Dict[int, List[int]]) -> bool:
    indeg = {n: 0 for n in succ}
    for cs in succ.values():
        for c in cs:
            indeg[c] = indeg.get(c, 0) + 1
    ready = [n for n, d in indeg.items() if d == 0]
    seen = 0
    while ready:
        n = ready.pop()
        seen += 1
        for c in succ.get(n, ()):
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    return seen == len(indeg)


def _dedup(seq):
    seen, out = set(), []
    for x in seq:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


class Structure:
    """Structured program + segmentation for one TraceGraph version."""

    def __init__(self, tg: TraceGraph):
        self.tg = tg
        succ = {uid: _dedup(n.children) for uid, n in tg.nodes.items()}
        if not _is_dag(succ):
            raise ValueError("TraceGraph must be a DAG")
        # post-dominators = dominators of the reversed graph rooted at END
        rev: Dict[int, List[int]] = {uid: [] for uid in succ}
        for uid, cs in succ.items():
            for c in cs:
                rev[c].append(uid)
        self.ipdom: Dict[int, int] = immediate_dominators(rev, tg.end.uid)
        self.program = self._build(tg.start.uid, tg.end.uid)
        self.segments = self._segment(self.program)

    # -- region construction -------------------------------------------------
    def _build(self, cur: int, stop: int) -> list:
        tg = self.tg
        seq: List = []
        while cur != stop:
            children = _dedup(tg.nodes[cur].children)
            if not children:
                break
            if len(children) == 1:
                nxt = children[0]
                if nxt == stop:
                    break
                seq.append(NodeItem(nxt))
                cur = nxt
            else:
                join = self.ipdom[cur]
                branches = []
                for c in children:
                    if c == join:
                        branches.append([])
                    else:
                        branches.append([NodeItem(c)] + self._build(c, join))
                seq.append(SwitchItem(cur, branches, join,
                                      child_order=tuple(children)))
                if join == stop:
                    break
                if tg.nodes[join].kind not in ("end",):
                    seq.append(NodeItem(join))
                cur = join
        return seq

    # -- segmentation ---------------------------------------------------------
    def _segment(self, program: list) -> List[list]:
        segments, cur = [], []
        for item in program:
            cur.append(item)
            if (isinstance(item, NodeItem)
                    and self.tg.nodes[item.uid].sync_after):
                segments.append(cur)
                cur = []
        segments.append(cur)
        return segments

    # -- helpers used by graphgen and the runner ------------------------------
    def iter_items(self, program=None):
        for item in (self.program if program is None else program):
            yield item
            if isinstance(item, SwitchItem):
                for b in item.branches:
                    yield from self.iter_items(b)

    def uids_in(self, program) -> List[int]:
        """All op/loop node uids contained in a (sub)program, including
        switch-branch interiors.  Fork uids are NodeItems of their own and
        are therefore not double-counted."""
        return [item.uid for item in self.iter_items(program)
                if isinstance(item, NodeItem)]
