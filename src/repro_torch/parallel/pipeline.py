"""GPipe-style pipeline parallelism over a 1-D mesh axis.

The ``pod`` axis of the multi-pod mesh can act as a pipeline axis: each
rank along it holds a contiguous group of super-blocks, and microbatches
stream through the stages, activations moving between neighbours with
``dist.batch_isend_irecv`` (the reference's ``ppermute``).  Bubble
fraction = (S-1)/(M+S-1) for S stages and M microbatches
(:func:`bubble_fraction`).

Each rank runs the same tick loop; a stage computes only in the M ticks
it is busy (stage s: ticks s .. s+M-1), so the idle ticks are the bubble.
At the end the last stage's outputs are replicated along the axis (a sum
of the masked value, as the reference's ``psum``).  The module works on
any 1-D axis of a ``DeviceMesh``: the tests run it on CPU processes over
gloo.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.pytree import tree_map


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_forward(stage_fn: Callable, n_stages: int, group):
    """Build a pipelined forward: ``stage_fn(stage_params, x) -> x``.

    Returns fn(stage_params, microbatches [M, mb, ...]) -> [M, mb, ...],
    run by every rank of ``group`` (rank s holds stage s's params and
    receives every microbatch; the output is replicated)."""
    import torch.distributed as dist

    def pipelined(stage_params, mbs):
        M = mbs.shape[0]
        stage = dist.get_rank(group)
        prev = dist.get_global_rank(group, stage - 1) if stage else None
        nxt = (dist.get_global_rank(group, stage + 1)
               if stage < n_stages - 1 else None)
        outs = torch.zeros_like(mbs)
        buf = torch.empty_like(mbs[0])
        for t in range(M + n_stages - 1):
            ops = []
            busy = stage <= t < stage + M
            if busy:
                x_in = mbs[t] if stage == 0 else buf
                y = stage_fn(stage_params, x_in)
                if nxt is None:                  # emits microbatch t-S+1
                    outs[t - stage] = y
                else:
                    ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt,
                                          group))
            # the previous stage is busy this tick: its output arrives
            if prev is not None and stage - 1 <= t < stage - 1 + M:
                buf = torch.empty_like(mbs[0])
                ops.append(dist.P2POp(dist.irecv, buf, prev, group))
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
        if stage != n_stages - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
        return outs

    return pipelined


def make_pipelined_apply(mesh, axis: str, stage_fn: Callable):
    """Stage params with a leading dim of n_stages (rank s takes entry s;
    a DTensor sharded over ``axis`` gives its local entry), microbatches
    replicated in, outputs replicated out."""
    n_stages = mesh[axis].size()
    group = mesh.get_group(axis)
    fn = pipeline_forward(stage_fn, n_stages, group)
    stage = mesh.get_local_rank(axis)

    def own(a):
        from torch.distributed.tensor import DTensor
        if isinstance(a, DTensor):
            return a.to_local()[0]
        return a[stage]

    def sharded(stacked_params, mbs):
        return fn(tree_map(own, stacked_params), mbs)

    return sharded
