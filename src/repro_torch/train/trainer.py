"""The imperative training driver, executed through Terra co-execution.

This is the paper's technique integrated as a first-class framework
feature: the user-visible training loop is ordinary imperative Python
(logging, checkpointing, adaptive hyper-parameters, third-party calls all
work), while the heavy ``train_step`` — a single composite Terra op wrapping
the whole step function — runs on the GraphRunner asynchronously.
Python-side overhead (data staging, bookkeeping, checkpoint scheduling) is
hidden behind device execution as in the paper's Fig. 6.

Fault tolerance:
  * periodic checkpoints (async commit, atomic rename) + auto-resume,
  * a step watchdog flags stragglers (slow steps) and records them — the
    mitigation hook for a real cluster scheduler,
  * the data pipeline reseeks deterministically on restart.

The trainer runs on ``device`` (default: the CUDA card; without one it
raises unless ``device="cpu"``).  ``state_tree()`` reads the variables'
committed values from the engine, so a checkpoint holds the trained
state.  (The reference reads ``Variable.value()`` outside the engine,
which returns the initial values under co-execution; ``ROADMAP.md``
Queue 3 records the difference.)

With a ``mesh`` (a ``DeviceMesh``, one trainer per rank) params and
optimizer state are placed by ``parallel.specs`` (``tree_shardings``), a
checkpoint is restored onto the mesh (reshard-on-load), and the step runs
under the policy (``train_step``: DTensors, the batch sharded over
``data``).  The Terra Variables hold each rank's local shards, so the
engine sees plain tensors; the step op wraps them as DTensors and holds
every collective.  ``state_tree()`` gathers the full tree on every rank
(after the engine has drained, so no collective of the step runs beside
the gathers), and rank 0 writes the checkpoints.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import Variable, function as terra_function
from repro_torch.core.device import resolve_device
from repro_torch.core.ops import def_op
from repro_torch.core.pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.core.trace import as_tensor
from repro_torch.models import model as M
from repro_torch.parallel import specs
from repro_torch.parallel.sharding import ShardingPolicy, use_policy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step


def _as_dtensors(leaves, mesh, layouts):
    """State leaves (each rank's local shards under a mesh) as DTensors;
    the leaves themselves without one (``layouts`` None)."""
    if layouts is None:
        return list(leaves)
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(x, mesh, pl, run_check=False, shape=shape,
                               stride=stride)
            for x, (pl, shape, stride) in zip(leaves, layouts)]


def _local_shards(leaves, mesh, layouts):
    """New state leaves as the Variables hold them: under a mesh each
    rank's local shard at the leaf's own placements."""
    if layouts is None:
        return tuple(leaves)
    return tuple(x.redistribute(mesh, pl).to_local()
                 for x, (pl, _, _) in zip(leaves, layouts))


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: Optional[opt.OptConfig] = None,
                 *, ckpt_dir: Optional[str] = None, seed: int = 0,
                 batch: int = 8, seq_len: int = 128, microbatches: int = 1,
                 mesh=None, log_every: int = 10, ckpt_every: int = 100,
                 straggler_factor: float = 3.0, use_terra: bool = True,
                 device=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg or opt.OptConfig()
        self.ckpt_dir = ckpt_dir
        self.batch, self.seq_len = batch, seq_len
        self.log_every, self.ckpt_every = log_every, ckpt_every
        self.straggler_factor = straggler_factor
        self.mesh = mesh
        self.policy = ShardingPolicy(mesh)
        self.use_terra = use_terra
        self.device = dev = resolve_device(device)
        self.history: list = []
        self.straggler_events: list = []
        self._saving = None                 # the async save in flight

        params = M.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                               device=dev)
        opt_state = opt.init(params)
        state = {"params": params, "opt": opt_state}
        shardings = None
        if mesh is not None:
            p_sh = specs.tree_shardings(mesh, params)
            shardings = {"params": p_sh,
                         "opt": specs.opt_state_shardings(mesh, p_sh)}
        self.start_step = 0
        last = ckpt.latest_step(ckpt_dir) if ckpt_dir is not None else None
        if last is not None:
            # auto-resume: params+opt are stored together as one tree
            state = ckpt.restore(ckpt_dir, last, state, shardings=shardings)
            self.start_step = last
        elif shardings is not None:
            state = tree_map(specs.distribute, state, shardings)
        params, opt_state = state["params"], state["opt"]

        # flatten state into Terra Variables (graph-resident): under a
        # mesh each rank's local shards, with what rebuilds the DTensors
        self._p_leaves, self._p_def = tree_flatten(params)
        self._o_leaves, self._o_def = tree_flatten(opt_state)
        self._layouts = None
        if mesh is not None:
            self._layouts = [(x.placements, x.shape, x.stride()) for x in
                             self._p_leaves + self._o_leaves]
            self._p_leaves = [x.to_local() for x in self._p_leaves]
            self._o_leaves = [x.to_local() for x in self._o_leaves]
        self.p_vars = [Variable(x, f"p{i}") for i, x in
                       enumerate(self._p_leaves)]
        self.o_vars = [Variable(x, f"o{i}") for i, x in
                       enumerate(self._o_leaves)]

        step_fn = build_train_step(cfg, self.opt_cfg,
                                   microbatches=microbatches)
        n_p, n_o = len(self._p_leaves), len(self._o_leaves)
        p_def, o_def = self._p_def, self._o_def

        # the op registry (def_op) keeps this closure: it must not hold
        # the trainer, whose state would then outlive it
        policy, layouts = self.policy, self._layouts

        def flat_step(*args):
            state = _as_dtensors(args[:n_p + n_o], mesh, layouts)
            p = tree_unflatten(p_def, state[:n_p])
            o = tree_unflatten(o_def, state[n_p:])
            tokens, labels = args[n_p + n_o], args[n_p + n_o + 1]
            with use_policy(policy):
                new_p, new_o, metrics = step_fn(p, o, {"tokens": tokens,
                                                       "labels": labels})
            return (_local_shards(tree_leaves(new_p) + tree_leaves(new_o),
                                  mesh, layouts)
                    + (metrics["loss"], metrics["grad_norm"]))

        self._flat_step_op = def_op(f"train_step::{cfg.name}", flat_step)
        self.dataset = data_mod.SyntheticLMDataset(
            cfg.vocab, seq_len, batch, seed=seed)

        def train_iteration(tokens, labels):
            args = ([v.read() for v in self.p_vars]
                    + [v.read() for v in self.o_vars]
                    + [tokens, labels])
            outs = self._flat_step_op(*args)
            for v, o in zip(self.p_vars, outs[:n_p]):
                v.assign(o)
            for v, o in zip(self.o_vars, outs[n_p:n_p + n_o]):
                v.assign(o)
            return outs[-2], outs[-1]          # loss, grad_norm

        if use_terra:
            self._iteration = terra_function(train_iteration, seed=seed,
                                             device=dev)
        else:
            # plain eager path: no engine stages the feeds, so stage the
            # batch onto the device here
            def eager_iteration(tokens, labels):
                return train_iteration(as_tensor(tokens, dev),
                                       as_tensor(labels, dev))
            self._iteration = eager_iteration

    # ------------------------------------------------------------------
    @property
    def writes_checkpoints(self) -> bool:
        """Rank 0 writes (every rank without a mesh)."""
        return self.mesh is None or self.mesh.get_rank() == 0

    def _value(self, v: Variable):
        if self.use_terra:
            return self._iteration.engine.variable_value(v)
        return v.value()

    def state_tree(self):
        """The full state tree (under a mesh gathered on every rank: a
        collective, so every rank calls it)."""
        if self._layouts is not None and self.use_terra:
            self._iteration.wait()
        leaves = _as_dtensors([self._value(v)
                               for v in self.p_vars + self.o_vars],
                              self.mesh, self._layouts)
        if self._layouts is not None:
            leaves = [x.full_tensor() for x in leaves]
        n_p = len(self.p_vars)
        return {"params": tree_unflatten(self._p_def, leaves[:n_p]),
                "opt": tree_unflatten(self._o_def, leaves[n_p:])}

    def _save(self, step: int, blocking: bool):
        """One save at a time: a save waits for the async one before it,
        so the final (blocking) save of a step an async save also wrote
        never swaps the directory while that one does, and nothing is
        left writing when ``train`` returns."""
        tree = self.state_tree()
        if self.writes_checkpoints:
            if self._saving is not None:
                self._saving.join()
            self._saving = ckpt.save(self.ckpt_dir, step, tree,
                                     blocking=blocking)

    # ------------------------------------------------------------------
    def train(self, num_steps: int, verbose: bool = True):
        it = data_mod.PrefetchIterator(self.dataset,
                                       start_step=self.start_step)
        step_times: list = []
        try:
            with use_policy(self.policy):
                for step in range(self.start_step,
                                  self.start_step + num_steps):
                    batch = next(it)
                    t0 = time.perf_counter()
                    loss_t, gnorm_t = self._iteration(batch["tokens"],
                                                      batch["labels"])
                    dt = time.perf_counter() - t0
                    step_times.append(dt)
                    # straggler watchdog (mitigation hook)
                    med = float(np.median(step_times[-50:]))
                    if len(step_times) > 10 and \
                            dt > self.straggler_factor * med:
                        self.straggler_events.append((step, dt, med))
                    if (step + 1) % self.log_every == 0:
                        loss = float(loss_t)           # Output Fetching
                        self.history.append((step + 1, loss))
                        if verbose:
                            phase = (self._iteration.phase
                                     if self.use_terra else "eager")
                            print(f"step {step + 1:5d} loss {loss:.4f} "
                                  f"[{phase}] {dt * 1e3:.1f}ms")
                    if (self.ckpt_dir is not None
                            and (step + 1) % self.ckpt_every == 0):
                        self._save(step + 1, blocking=False)
        finally:
            it.close()
        if self.ckpt_dir is not None:
            self._save(self.start_step + num_steps, blocking=True)
        return self.history
