"""AdamW + schedules + clipping in plain torch (no torch.optim).

Mixed precision: when model params are bf16, the optimizer keeps f32 master
copies and casts back after the update (2+4+4+4 bytes/param total with the
two moments).  The state tree is the reference's: ``step`` (int32 0-d),
``m``, ``v`` and ``master``, each of the last three a tree of the params'
structure.  Every update is out of place (the engine's variable store is
never written in place) and reads nothing back to the host."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.core.pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step):
    """Linear warmup + cosine decay to min_lr_frac (f32; ``step`` a tensor
    or a number)."""
    step = (step.to(torch.float32) if isinstance(step, torch.Tensor)
            else torch.tensor(float(step)))
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params) -> dict:
    def zeros_f32(p):
        # zeros_like: a DTensor param (under a mesh) gives its placements
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros_f32, params),
        "v": tree_map(zeros_f32, params),
        # a copy even for f32 params: the master never aliases a param
        "master": tree_map(lambda p: p.to(torch.float32, copy=True), params),
    }


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def apply(cfg: OptConfig, state: dict, grads, params) -> Tuple[Any, dict, dict]:
    """One AdamW update.  Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(g, m, v, master):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        new_master = master - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                    + cfg.weight_decay * master)
        return m, v, new_master

    flat_g, treedef = tree_flatten(grads)
    out = [upd(g, m, v, ma) for g, m, v, ma in
           zip(flat_g, tree_leaves(state["m"]), tree_leaves(state["v"]),
               tree_leaves(state["master"]))]
    new_m = tree_unflatten(treedef, [o[0] for o in out])
    new_v = tree_unflatten(treedef, [o[1] for o in out])
    new_master = tree_unflatten(treedef, [o[2] for o in out])
    new_params = tree_map(lambda ma, p: ma.to(p.dtype), new_master, params)
    new_state = {"step": step, "m": new_m, "v": new_v, "master": new_master}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, new_state, metrics
