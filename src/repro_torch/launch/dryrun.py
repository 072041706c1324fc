"""Multi-pod dry run: run every (architecture x input-shape x mesh) cell on
``meta`` tensors over a fake process group and count, per card, the
FLOPs, bytes, collectives and memory of one step.  No tensor is ever
allocated on a device — parameters, optimizer state, caches and batches
are ``meta`` tensors (DTensors of ``meta`` shards under the mesh) — so no
card is needed.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

The mesh is a ``DeviceMesh`` of device type ``"cuda"`` over a process
group of the ``fake`` backend with one rank per card (256 single pod, 512
multi pod), built inside :func:`run_cell` and destroyed before it
returns.  This process is rank 0: the counts are one card's.  DTensor
plans its collectives as it does on the cards (an all-to-all is an
all-to-all; on a ``"cpu"`` mesh DTensor would swap it for an all-gather).

What is counted, by :class:`Counter` (a ``TorchDispatchMode`` that sees
the local ops DTensor runs on each card's shards):

* FLOPs: the matmul-class ops that ``torch.utils.flop_counter`` has a
  formula for (mm, bmm, addmm, baddbmm, convolutions, attention), at
  their local shapes.  DTensor's sharding propagation also runs each op
  once at global shapes, on fake tensors; those runs are not counted.
  XLA's cost analysis counts every HLO op, elementwise ones included, so
  the reference's ``flops`` are somewhat higher for the same step.
* ``xla_bytes_upper_bound``: the input plus output bytes of every local
  op that is not a view — every operand of every unfused op, which is
  what XLA-CPU's "bytes accessed" measures.  The roofline's memory term
  is the analytic model ``roofline.analytic_memory_bytes``, as in the
  reference.
* Collectives: every collective the program issues, functional ones
  (DTensor's) and the c10d ops behind ``torch.distributed`` calls
  (``models/moe_ep.py``'s ``all_to_all_single``), logged as (kind,
  operand shape, dtype).
* Memory: the live bytes of the step's local tensors, by storage — the
  arguments, the outputs, the peak and the outputs that alias donated
  arguments (``roofline.memory_report``).

FLOPs, bytes and collectives come, as in the reference, from a two-point
extrapolation over reduced depths (``reduced_cfg`` k = 2, 3) with train
probes at microbatch scale: the port runs its layers in Python, so a
direct count is exact too, but DTensor's dispatch per op (about half a
millisecond on a host core) makes a full-depth count slow.  For the same
reason the memory of a stack deeper than 3 super-blocks is extrapolated
from 2 and 3 super-blocks of the full cell (its batch, attention blocks
and microbatches); the reference reads it from the full-depth compile.
The multi-pod pass reports memory only, with no cost probes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _pt_flatten

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.registry import ARCHS, LONG_CONTEXT_ARCHS
from repro_torch.core.pytree import tree_map
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (HBM_BW, HBM_PER_CHIP, NVLINK_BW,
                                     PEAK_FLOPS_BF16, make_production_mesh)
from repro_torch.models import model as M
from repro_torch.parallel import specs as S
from repro_torch.parallel.sharding import ShardingPolicy, sharded, use_policy
from repro_torch.serve.serve_step import build_decode_step, build_prefill_step
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step


def cell_is_defined(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


# train cells use gradient accumulation (production-realistic): global batch
# 256 x 4096 tokens does not fit activations otherwise.
TRAIN_MICROBATCHES = 8


def depth_cfg(cfg, k: int):
    """Same config with k super-blocks (and k encoder layers)."""
    repl = {"n_layers": k * len(cfg.block_pattern) + len(cfg.extra_blocks)}
    if cfg.enc_layers:
        repl["enc_layers"] = k
    return dataclasses.replace(cfg, **repl)


def reduced_cfg(cfg, k: int):
    """Same architecture with k super-blocks (and k encoder layers) — used
    for the two-point cost extrapolation: per-layer marginal cost =
    F(3) - F(2), total = F(2) + (nb-2)*(F3-F2).  Exact for homogeneous
    stacks."""
    # keep the attention-block count small: FLOPs are invariant to the
    # block size (fully-masked blocks are still computed), so probes use
    # coarse blocks for dispatch speed.
    return dataclasses.replace(depth_cfg(cfg, k), unroll=True, q_block=8192,
                               kv_block=16384, ssd_chunk=4096)


@contextlib.contextmanager
def _arch_as(arch: str, cfg):
    """The registry's ``arch`` is ``cfg`` inside the block."""
    import repro_torch.configs.registry as REG
    orig = REG.ARCHS[arch]
    REG.ARCHS[arch] = cfg
    try:
        yield
    finally:
        REG.ARCHS[arch] = orig


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for single-pass inference
    (N = active params, D = tokens processed in the step)."""
    n_active = M.active_param_count(cfg)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_active * toks
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# --------------------------------------------------------------------------
# the fake mesh and the counter
# --------------------------------------------------------------------------

@contextlib.contextmanager
def fake_mesh(shape: Dict[str, int]):
    """A ``DeviceMesh`` of device type ``"cuda"`` with axes ``shape``
    (name -> size) over a ``fake`` process group of that many ranks,
    this process rank 0; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process "
                           "group")
    n = math.prod(shape.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield DeviceMesh("cuda", torch.arange(n).reshape(
            tuple(shape.values())), mesh_dim_names=tuple(shape))
    finally:
        dist.destroy_process_group()


# collective op -> (kind, index of its operand argument)
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
}
# DTensor ops that may fail on a sharded input (Counter._resharded)
_RESHARDED = {torch.ops.aten.view.default,
              torch.ops.aten._unsafe_view.default,
              torch.ops.aten.reshape.default,
              torch.ops.aten.argmax.default, torch.ops.aten.argmin.default}
# ops that move no bytes: the functional collectives' wrappers
_NO_BYTES = {"_c10d_functional.wait_tensor",
             "_c10d_functional._wrap_tensor_autograd"}


# DTensor's own planning code: its propagator, its op rules and its
# arg-reduction handler (whose gather of an unevenly sharded dim fails on
# meta tensors)
_DTENSOR_PLANNING = ("distributed/tensor/_sharding_prop.py",
                     "distributed/tensor/_ops/",
                     "distributed/tensor/_nonlinear_redux.py")


def _refused(e: BaseException) -> bool:
    """Whether ``e`` is DTensor refusing an op's placements: ``e``, or an
    exception it was raised from, passed through DTensor's planning code
    (``_DTENSOR_PLANNING``).  An error of the op itself on its local
    shards does not."""
    import pathlib
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        for frame in traceback.extract_tb(e.__traceback__):
            tail = "/".join(pathlib.PurePath(frame.filename).parts[-5:])
            if any(m in tail for m in _DTENSOR_PLANNING):
                return True
        e = e.__cause__ or e.__context__
    return False


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in _pt_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class Counter(TorchDispatchMode):
    """Counts the local ops of one card: FLOPs, bytes, collectives and
    the live bytes of tensor storages (``meta`` storages have sizes).
    A DTensor op returns ``NotImplemented`` here, so DTensor runs it and
    the mode sees the local ops it becomes; an op on fake tensors is
    DTensor's sharding propagation at global shapes, not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: List[Tuple[str, Tuple[int, ...], str]] = []
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._resharding = False
        self.resharded: Dict[str, Dict[str, int]] = {}

    def _resharded(self, func, args, kwargs):
        """A view or an arg-reduction of a DTensor.  DTensor refuses to
        split a sharded dim it cannot split shard by shard (the GQA
        grouping of 32 heads as 8 x 4 on a 16-wide axis, say; some
        versions refuse any split of a sharded dim), and its argmax over
        an unevenly sharded dim fails on meta tensors: then the input is
        first replicated over every mesh dim that shards a dim other than
        the first, as XLA's partitioner reshards it, and the op is tried
        once more; failing again, on the input replicated whole.  Only
        DTensor's own refusals are retried (:func:`_refused`); each retry
        that succeeds is counted in ``resharded`` by op and stage
        (``"dims"``, ``"whole"``), for the record's ``resharded_ops``."""
        from torch.distributed.tensor import Replicate, Shard
        self._resharding = True
        try:
            with self:
                try:
                    return func(*args, **kwargs)
                except RuntimeError as e:
                    if not _refused(e):
                        raise
                x = args[0]
                pl = [Replicate() if isinstance(p, Shard) and p.dim != 0
                      else p for p in x.placements]
                try:
                    out = func(x.redistribute(x.device_mesh, pl),
                               *args[1:], **kwargs)
                    self._count_resharded(func, "dims")
                    return out
                except RuntimeError as e:
                    if not _refused(e):
                        raise
                # the first dim is split too
                out = func(x.redistribute(
                    x.device_mesh, [Replicate()] * x.device_mesh.ndim),
                    *args[1:], **kwargs)
                self._count_resharded(func, "whole")
                return out
        finally:
            self._resharding = False

    def _count_resharded(self, func, stage):
        per_op = self.resharded.setdefault(str(func._overloadpacket), {})
        per_op[stage] = per_op.get(stage, 0) + 1

    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` (DTensors by their local
        shards) as live until they are freed; returns their bytes that
        were not live yet."""
        added = 0
        for t in _tensors(tensors):
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            weakref.finalize(st, self._free, key)
            added += n
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if func in _RESHARDED and not self._resharding:
                return self._resharded(func, args, kwargs)
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins + _tensors(out)):
            return out                  # DTensor's propagation run
        name = str(func._overloadpacket)
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            kind, i = coll
            for t in _tensors(args[i]):
                self.collectives.append((kind, tuple(t.shape),
                                         str(t.dtype).split(".")[-1]))
        formula = self._flop_formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_BYTES:
            self.bytes_accessed += sum(
                t.numel() * t.element_size() for t in ins + _tensors(out))
        self.track(out)
        return out


@dataclasses.dataclass
class Counts:
    """One step's counts on one card (the port's ``compiled``)."""
    flops: float
    bytes_accessed: float
    collectives: List[Tuple[str, Tuple[int, ...], str]]
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int
    resharded: Dict[str, Dict[str, int]]


class Lowered:
    """One cell's step and its ``meta`` arguments; :meth:`run` runs the
    step once under a :class:`Counter` and returns its :class:`Counts`.
    ``donate``: the indices of arguments whose buffers the outputs of
    the same shapes may take over (the decode cache)."""

    def __init__(self, fn, args, mesh, out_shardings=None, donate=()):
        self.fn, self.args, self.mesh = fn, args, mesh
        self.out_shardings, self.donate = out_shardings, tuple(donate)

    def run(self) -> Counts:
        c = Counter()
        arg_bytes = c.track(self.args)
        with use_policy(ShardingPolicy(self.mesh)), sharded(), c:
            out = self.fn(*self.args)
            if self.out_shardings is not None:
                out = tree_map(_place, out, self.out_shardings)
        arg_ids = {id(_local(t).untyped_storage())
                   for t in _tensors(self.args)}
        seen, out_bytes = set(), 0
        for t in _tensors(out):
            st = _local(t).untyped_storage()
            if id(st) not in arg_ids | seen:
                seen.add(id(st))
                out_bytes += st.nbytes()
        alias = 0
        for i in self.donate:
            have = [(tuple(_local(t).shape), _local(t).dtype)
                    for t in _tensors(self.args[i])]
            for t in _tensors(out):
                key = (tuple(_local(t).shape), _local(t).dtype)
                if key in have:
                    have.remove(key)
                    alias += _local(t).untyped_storage().nbytes()
        return Counts(c.flops, c.bytes_accessed, c.collectives, arg_bytes,
                      out_bytes, max(c.peak - arg_bytes - out_bytes, 0),
                      alias, c.resharded)


def _place(x, sharding):
    """An output at its out-sharding, as ``jax.jit(out_shardings=)``
    gives it (a plain tensor is taken as replicated)."""
    from repro_torch.parallel.sharding import as_dtensor
    if not isinstance(x, torch.Tensor) or sharding is None:
        return x
    return as_dtensor(x, sharding.mesh).redistribute(sharding.mesh,
                                                     sharding.placements)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ns(mesh, spec_tree):
    return tree_map(lambda s: S.NamedSharding(mesh, s), spec_tree)


def _put(tree, shardings):
    return tree_map(S.distribute, tree, shardings)


def lower_cell(arch: str, shape_name: str, mesh, *, microbatches: int = 1,
               donate: bool = True, cost_probe: bool = False,
               opts: Optional[Dict[str, Any]] = None):
    """Build and return (lowered, aux) for one cell: its step and its
    ``meta`` arguments placed on ``mesh`` (a ``DeviceMesh``)."""
    opts = opts or {}
    cfg = get_config(arch)
    if opts.get("remat_policy") or opts.get("moe_impl"):
        repl = {}
        if opts.get("remat_policy"):
            repl["remat_policy"] = opts["remat_policy"]
        if opts.get("moe_impl"):
            repl["moe_impl"] = opts["moe_impl"]
        cfg = dataclasses.replace(cfg, **repl)
    shape = SHAPES[shape_name]
    aparams = M.abstract_params(cfg)
    fsdp = opts.get("serve_fsdp", True) if shape_name != "train_4k" else True
    pspecs = S.tree_param_specs(mesh, aparams, fsdp=fsdp)
    psh = _ns(mesh, pspecs)
    params = _put(aparams, psh)
    B = shape.global_batch
    dt = getattr(torch, cfg.dtype)

    extras: Dict[str, Any] = {}
    if cfg.family == "vlm":
        extras["cross_states"] = _meta((B, cfg.frontend_tokens,
                                        cfg.d_model), dt)
    if cfg.family == "audio":
        extras["frontend_embeds"] = _meta((B, cfg.frontend_tokens,
                                           cfg.d_model), torch.float32)

    def batch_sharded(x):
        return S.distribute(x, S.NamedSharding(
            mesh, S.batch_spec(mesh, tuple(x.shape))))

    if shape.kind == "train":
        oc = opt.OptConfig()
        ostate = opt.init(params)
        # the step shards each microbatch of the whole batch itself
        batch = {"tokens": _meta((B, shape.seq_len), torch.int32),
                 "labels": _meta((B, shape.seq_len), torch.int32),
                 **extras}
        mb = (microbatches if cost_probe else
              max(microbatches, opts.get("microbatches",
                                         TRAIN_MICROBATCHES)))
        step = build_train_step(cfg, oc, microbatches=mb)
        osh = _ns(mesh, S.opt_state_specs(mesh, ostate, pspecs))
        rep = S.NamedSharding(mesh, S.P())
        out_sh = (psh, osh, {"loss": rep, "grad_norm": rep, "lr": rep})
        return (Lowered(step, (params, ostate, batch), mesh, out_sh),
                {"cfg": cfg, "shape": shape})

    if shape.kind == "prefill":
        tokens = batch_sharded(_meta((B, shape.seq_len), torch.int32))
        keys = sorted(extras)
        fn = build_prefill_step(cfg, shape.seq_len)

        def prefill_pos(params, tokens, *extra_vals):
            return fn(params, tokens, **dict(zip(keys, extra_vals)))

        acache = M.init_cache(cfg, B, shape.seq_len, device="meta")
        acache["len"] = _meta((), torch.int32)
        csh = _ns(mesh, S.tree_cache_specs(mesh, acache))
        out_sh = (S.NamedSharding(mesh, S.batch_spec(mesh, (B,))), csh)
        args = (params, tokens) + tuple(batch_sharded(extras[k])
                                        for k in keys)
        return (Lowered(prefill_pos, args, mesh, out_sh),
                {"cfg": cfg, "shape": shape})

    # decode
    tokens = batch_sharded(_meta((B, 1), torch.int32))
    acache = M.init_cache(cfg, B, shape.seq_len, device="meta")
    acache["len"] = _meta((), torch.int32)
    csh = _ns(mesh, S.tree_cache_specs(mesh, acache))
    cache = _put(acache, csh)
    fn = build_decode_step(cfg)

    # audio decode attends to encoder states: supply them as cross_states
    extra_vals = ()
    if cfg.family in ("audio", "vlm"):
        extra_vals = (batch_sharded(_meta((B, cfg.frontend_tokens,
                                           cfg.d_model), dt)),)

    def decode_pos(params, cache, tokens, *extra_vals):
        return fn(params, cache, tokens, None, *extra_vals)

    out_sh = (S.NamedSharding(mesh, S.batch_spec(mesh, (B, 1))), csh)
    return (Lowered(decode_pos, (params, cache, tokens) + extra_vals, mesh,
                    out_sh, donate=(1,) if donate else ()),
            {"cfg": cfg, "shape": shape})


def _tally(into: Dict[str, Dict[str, int]], counts: Counts):
    """Add one run's counter fallbacks (``Counts.resharded``) to a
    cell's."""
    for op, stages in counts.resharded.items():
        mine = into.setdefault(op, {})
        for stage, n in stages.items():
            mine[stage] = mine.get(stage, 0) + n


def _cost_tuple(arch, shape_name, mesh, cfg_override, opts=None,
                tally=None):
    """(flops, bytes, per-collective wire bytes) for a reduced config;
    the run's counter fallbacks are added to ``tally``.

    Cost probes run at MICROBATCH scale with no accumulation loop; the
    caller multiplies train-cell results by TRAIN_MICROBATCHES — matching
    the real step, whose per-microbatch backward includes its gradient
    reduction."""
    shape = SHAPES[shape_name]
    opts = opts or {}
    n_mb = opts.get("microbatches", TRAIN_MICROBATCHES)
    probe_shape = shape
    if shape.kind == "train":
        probe_shape = dataclasses.replace(
            shape, name=shape.name + "-probe",
            global_batch=shape.global_batch // n_mb)
    SHAPES[probe_shape.name] = probe_shape
    try:
        with _arch_as(arch, cfg_override):
            lowered, _ = lower_cell(arch, probe_shape.name, mesh,
                                    microbatches=1, cost_probe=True,
                                    opts=opts)
        counts = lowered.run()
        if tally is not None:
            _tally(tally, counts)
        coll = RL.collective_bytes(counts.collectives)
        return float(counts.flops), float(counts.bytes_accessed), coll
    finally:
        if probe_shape.name != shape.name:
            del SHAPES[probe_shape.name]


def _memory(arch, shape_name, mesh, lowered, cfg, opts, tally):
    """The full cell's memory report (the runs' counter fallbacks are
    added to ``tally``).  A stack of at most 3 super-blocks
    runs as it is (``lowered``); a deeper one is extrapolated from 2 and
    3 super-blocks at the cell's own batch, blocks and microbatches, as
    the costs are: arguments, outputs, the peak and the aliases are each
    linear in depth for a homogeneous stack."""
    def report(low):
        counts = low.run()
        _tally(tally, counts)
        return RL.memory_report(counts)

    nb = cfg.n_pattern_blocks
    if nb <= 3:
        return report(lowered)
    ms = []
    for k in (2, 3):
        with _arch_as(arch, depth_cfg(cfg, k)):
            low, _ = lower_cell(arch, shape_name, mesh, opts=opts)
        ms.append(report(low))
    return {key: ms[0][key] + (nb - 2) * (ms[1][key] - ms[0][key])
            for key in ms[0]}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True, extrapolate: bool = True,
             opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One cell's record.  ``lower_s`` is the time to build the full
    cell's step and place its arguments, ``compile_s`` the time of the
    counted runs that follow.  ``resharded_ops`` (a key the reference's
    record does not have): the ops that DTensor refused on a sharded
    input and the counter re-ran on a replicated one, by op and stage
    (``Counter._resharded``), summed over the cell's counted runs — the
    collectives of those reshards are the counter's, not DTensor's
    plan."""
    opts = opts or {}
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "opts": opts}
    if not cell_is_defined(arch, shape_name):
        rec["status"] = "skipped"
        rec["reason"] = ("full-attention arch: long_500k requires "
                         "sub-quadratic attention (DESIGN.md §5)")
        return rec
    if opts.get("mesh_shape"):
        axes = dict(zip(("data", "model"), opts["mesh_shape"]))
    else:
        axes = make_production_mesh(multi_pod=(mesh_kind == "multi")).shape
    n_chips = math.prod(axes.values())
    # the roofline table is single-pod only; the multi-pod pass proves the
    # pod axis shards (build + run + memory), no probes
    if mesh_kind == "multi":
        extrapolate = False
    t0 = time.perf_counter()
    roof = None
    tally: Dict[str, Dict[str, int]] = {}
    try:
        with fake_mesh(axes) as mesh:
            lowered, aux = lower_cell(arch, shape_name, mesh, opts=opts)
            t_lower = time.perf_counter() - t0
            mem = _memory(arch, shape_name, mesh, lowered, aux["cfg"], opts,
                          tally)
            mf = model_flops(aux["cfg"], aux["shape"])
            # ---- two-point extrapolation over layers -------------------
            # k=2,3 as in the reference; train costs are per-microbatch,
            # scaled back up.
            if extrapolate:
                cfg = aux["cfg"]
                nb = cfg.n_pattern_blocks
                f2, b2, c2 = _cost_tuple(arch, shape_name, mesh,
                                         reduced_cfg(cfg, 2), opts=opts,
                                         tally=tally)
                f3, b3, c3 = _cost_tuple(arch, shape_name, mesh,
                                         reduced_cfg(cfg, 3), opts=opts,
                                         tally=tally)
                scale = (opts.get("microbatches", TRAIN_MICROBATCHES)
                         if aux["shape"].kind == "train" else 1)
                flops = (f2 + (nb - 2) * (f3 - f2)) * scale
                byt = (b2 + (nb - 2) * (b3 - b2)) * scale
                per_coll = {k: (c2[k] + (nb - 2) * (c3[k] - c2[k])) * scale
                            for k in c2}
                wire = sum(v for k, v in per_coll.items()
                           if k != "n_collectives")
                amem = RL.analytic_memory_bytes(
                    cfg, aux["shape"], n_chips,
                    microbatches=opts.get("microbatches",
                                          TRAIN_MICROBATCHES))
                rec["analytic_memory"] = {k: round(v)
                                          for k, v in amem.items()}
                rec["xla_bytes_upper_bound"] = byt
                roof = RL.Roofline(
                    flops=flops, bytes_accessed=amem["total"],
                    wire_bytes=wire,
                    compute_s=flops / PEAK_FLOPS_BF16,
                    memory_s=amem["total"] / HBM_BW,
                    collective_s=wire / NVLINK_BW, per_coll=per_coll,
                    model_flops_per_device=mf / n_chips)
        t_compile = time.perf_counter() - t0 - t_lower
        rec.update(status="ok", lower_s=round(t_lower, 1),
                   compile_s=round(t_compile, 1), memory=mem,
                   fits_hbm=mem["total_nonalias_bytes"] <= HBM_PER_CHIP,
                   model_flops_total=mf, n_chips=n_chips,
                   resharded_ops=tally)
        if roof is not None:
            rec["roofline"] = roof.as_dict()
    except Exception as e:  # noqa: BLE001 — failures ARE the result here
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if verbose:
        status = rec["status"]
        extra = ""
        if status == "ok" and "roofline" in rec:
            r = rec["roofline"]
            extra = (f" compute={r['compute_s']:.3e}s "
                     f"memory={r['memory_s']:.3e}s "
                     f"coll={r['collective_s']:.3e}s dom={r['dominant']}"
                     f" fits={rec['fits_hbm']}")
        elif status == "ok":
            extra = (f" ran; fits={rec['fits_hbm']} "
                     f"(run {rec['compile_s']}s)")
        elif status == "error":
            extra = " " + rec["error"][:140]
        if status == "ok":
            extra += f" resharded={n_resharded(rec)}"
        print(f"[{arch} x {shape_name} x {mesh_kind}] {status}{extra}",
              flush=True)
    return rec


def n_resharded(rec) -> int:
    """The number of ops the counter re-ran on a replicated input in one
    record (0 for a record without ``resharded_ops``, the reference's)."""
    return sum(n for stages in rec.get("resharded_ops", {}).values()
               for n in stages.values())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = (["single", "multi"] if args.mesh == "both"
              else [args.mesh])
    if args.all:
        archs, shapes, meshes = sorted(ARCHS), list(SHAPES), ["single",
                                                              "multi"]
    results = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mesh_kind)
                results.append(rec)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
