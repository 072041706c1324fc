"""Train-step builder: loss, microbatched gradient accumulation, remat and
mixed precision.

``build_train_step(cfg, opt_cfg, microbatches=k)`` returns a pure function
    step(params, opt_state, batch) -> (params, opt_state, metrics)
of tensors, suitable for registration as a single Terra composite op
(train/trainer.py).  It computes its own gradients with
``torch.autograd.grad`` under ``torch.enable_grad()``: the engine runs
segments under ``torch.no_grad()``, where plain autograd would record
nothing.  The reference's ``lax.scan`` over microbatches is a Python loop.

Under a sharding policy with a mesh (``parallel.sharding.use_policy``)
the step is the reference's pjit step in DTensor form: params and
optimizer state are DTensors placed by ``parallel.specs`` (the caller
places them), the batch is given whole on every rank and each microbatch
is sharded over the batch axes here, DTensor propagates placements
through the model (``sharding.sharded``), each gradient is redistributed
to its param's placements (the data-parallel reduction), and the metrics
come back as plain, replicated tensors.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import model as M
from repro_torch.parallel import specs
from repro_torch.parallel.sharding import current_mesh, logical, sharded
from repro_torch.train import optimizer as opt


def lm_loss(cfg: ModelConfig, params, tokens, labels, *, extras=None,
            z_loss: float = 1e-4):
    """Next-token cross-entropy with z-loss, in f32.

    The reference extracts the label logit with a one-hot contraction (a
    gather across a vocab-sharded axis would all-gather the logits); the
    gather reads the same value, exactly, without the [B, S, vocab]
    one-hot.  Under a mesh DTensor has no correct rule for that gather
    (``sharding.NO_RULE_OPS``), so it reads logits replicated over the
    vocab."""
    kw = extras or {}
    logits = logical(M.forward(cfg, params, tokens, **kw),
                     "batch", None, "vocab").to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logical(logits, "batch", None, None), -1,
                      labels.long()[..., None])[..., 0]
    nll = (lse - ll).mean()
    zl = z_loss * torch.square(lse).mean()
    return nll + zl, {"nll": nll}


def _shard_batch(x):
    """A microbatch (whole on every rank) sharded over the batch axes of
    the current mesh; itself without one."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return specs.distribute(x, specs.NamedSharding(
        mesh, specs.batch_spec(mesh, tuple(x.shape))))


def _whole(x):
    """A metric as a plain tensor (a DTensor gathered: replicated)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _like_param(g, p):
    """A gradient at its param's placements (under a mesh: the reduction
    of partial sums and the data-parallel mean)."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def build_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig,
                     microbatches: int = 1, z_loss: float = 1e-4):
    def grads_of(params, tokens, labels, extras):
        leaves, treedef = tree_flatten(params)
        tokens, labels = _shard_batch(tokens), _shard_batch(labels)
        extras = {k: _shard_batch(v) for k, v in extras.items()}
        with torch.enable_grad():
            xs = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = lm_loss(cfg, tree_unflatten(treedef, xs), tokens,
                              labels, extras=extras, z_loss=z_loss)
            gs = torch.autograd.grad(loss, xs, materialize_grads=True)
        gs = [_like_param(g, p) for g, p in zip(gs, leaves)]
        return loss.detach(), tree_unflatten(treedef, gs)

    def step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        extras = {k: v for k, v in batch.items()
                  if k not in ("tokens", "labels")}

        with sharded():
            if microbatches == 1:
                loss, grads = grads_of(params, tokens, labels, extras)
            else:
                # gradient accumulation over the leading batch axis
                mb = tokens.shape[0] // microbatches
                gsum = tree_map(
                    lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
                lsum = 0.0
                for i in range(microbatches):
                    sl = slice(i * mb, (i + 1) * mb)
                    loss, g = grads_of(params, tokens[sl], labels[sl],
                                       {k: v[sl] for k, v in extras.items()})
                    gsum = tree_map(torch.add, gsum, g)
                    lsum = lsum + loss
                grads = tree_map(lambda g: g / microbatches, gsum)
                loss = lsum / microbatches

            new_params, new_state, om = opt.apply(opt_cfg, opt_state, grads,
                                                  params)
            metrics = {k: _whole(v) for k, v in {"loss": loss, **om}.items()}
        return new_params, new_state, metrics

    return step


@torch.no_grad()
def eval_step(cfg: ModelConfig, params, batch, z_loss: float = 0.0):
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    loss, aux = lm_loss(cfg, params, batch["tokens"], batch["labels"],
                        extras=extras, z_loss=z_loss)
    return {"loss": loss, **aux}
