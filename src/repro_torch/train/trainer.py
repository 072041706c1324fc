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
from repro_torch.core.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.core.trace import as_tensor
from repro_torch.models import model as M
from repro_torch.parallel.sharding import ShardingPolicy, use_policy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step


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

        params = M.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                               device=dev)
        opt_state = opt.init(params)
        self.start_step = 0
        if ckpt_dir is not None:
            last = ckpt.latest_step(ckpt_dir)
            if last is not None:
                # auto-resume: params+opt are stored together as one tree
                tree = ckpt.restore(ckpt_dir, last,
                                    {"params": params, "opt": opt_state})
                params, opt_state = tree["params"], tree["opt"]
                self.start_step = last

        # flatten state into Terra Variables (graph-resident)
        self._p_leaves, self._p_def = tree_flatten(params)
        self._o_leaves, self._o_def = tree_flatten(opt_state)
        self.p_vars = [Variable(x, f"p{i}") for i, x in
                       enumerate(self._p_leaves)]
        self.o_vars = [Variable(x, f"o{i}") for i, x in
                       enumerate(self._o_leaves)]

        step_fn = build_train_step(cfg, self.opt_cfg,
                                   microbatches=microbatches)
        n_p, n_o = len(self._p_leaves), len(self._o_leaves)
        p_def, o_def = self._p_def, self._o_def

        def flat_step(*args):
            p = tree_unflatten(p_def, args[:n_p])
            o = tree_unflatten(o_def, args[n_p:n_p + n_o])
            tokens, labels = args[n_p + n_o], args[n_p + n_o + 1]
            new_p, new_o, metrics = step_fn(p, o, {"tokens": tokens,
                                                   "labels": labels})
            return (tuple(tree_leaves(new_p))
                    + tuple(tree_leaves(new_o))
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
    def _value(self, v: Variable):
        if self.use_terra:
            return self._iteration.engine.variable_value(v)
        return v.value()

    def state_tree(self):
        params = tree_unflatten(self._p_def,
                                [self._value(v) for v in self.p_vars])
        ostate = tree_unflatten(self._o_def,
                                [self._value(v) for v in self.o_vars])
        return {"params": params, "opt": ostate}

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
                        ckpt.save(self.ckpt_dir, step + 1, self.state_tree(),
                                  blocking=False)
        finally:
            it.close()
        if self.ckpt_dir is not None:
            ckpt.save(self.ckpt_dir, self.start_step + num_steps,
                      self.state_tree(), blocking=True)
        return self.history
