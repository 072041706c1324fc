"""Train-step builder: loss, microbatched gradient accumulation, remat and
mixed precision.

``build_train_step(cfg, opt_cfg, microbatches=k)`` returns a pure function
    step(params, opt_state, batch) -> (params, opt_state, metrics)
of tensors, suitable for registration as a single Terra composite op
(train/trainer.py).  It computes its own gradients with
``torch.autograd.grad`` under ``torch.enable_grad()``: the engine runs
segments under ``torch.no_grad()``, where plain autograd would record
nothing.  The reference's ``lax.scan`` over microbatches is a Python loop.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import model as M
from repro_torch.parallel.sharding import logical
from repro_torch.train import optimizer as opt


def lm_loss(cfg: ModelConfig, params, tokens, labels, *, extras=None,
            z_loss: float = 1e-4):
    """Next-token cross-entropy with z-loss, in f32.

    The reference extracts the label logit with a one-hot contraction (a
    gather across a vocab-sharded axis would all-gather the logits); on
    one device the gather reads the same value, exactly, without the
    [B, S, vocab] one-hot."""
    kw = extras or {}
    logits = logical(M.forward(cfg, params, tokens, **kw),
                     "batch", None, "vocab").to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (lse - ll).mean()
    zl = z_loss * torch.square(lse).mean()
    return nll + zl, {"nll": nll}


def build_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig,
                     microbatches: int = 1, z_loss: float = 1e-4):
    def grads_of(params, tokens, labels, extras):
        leaves, treedef = tree_flatten(params)
        with torch.enable_grad():
            xs = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = lm_loss(cfg, tree_unflatten(treedef, xs), tokens,
                              labels, extras=extras, z_loss=z_loss)
            gs = torch.autograd.grad(loss, xs, materialize_grads=True)
        return loss.detach(), tree_unflatten(treedef, list(gs))

    def step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        extras = {k: v for k, v in batch.items()
                  if k not in ("tokens", "labels")}

        if microbatches == 1:
            loss, grads = grads_of(params, tokens, labels, extras)
        else:
            # gradient accumulation over the leading batch axis
            mb = tokens.shape[0] // microbatches
            gsum = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
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
        metrics = {"loss": loss, **om}
        return new_params, new_state, metrics

    return step


@torch.no_grad()
def eval_step(cfg: ModelConfig, params, batch, z_loss: float = 0.0):
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    loss, aux = lm_loss(cfg, params, batch["tokens"], batch["labels"],
                        extras=extras, z_loss=z_loss)
    return {"loss": loss, **aux}
