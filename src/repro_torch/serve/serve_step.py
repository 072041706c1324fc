"""Serving steps: prefill and single-token decode, captured on the card.

The counterpart of the reference's ``serve/serve_step.py``.  ``prefill``
runs the model over a batch of same-length prompts into a fresh dense
cache and takes the greedy first token; ``decode`` is one new token
against that cache.  The cache's fill length ``len`` is an int32 0-d
tensor on the device, as it is an array in the reference, so every decode
step of a batch has the same shapes and one CUDA graph serves them all.

Sampling is greedy at temperature 0; above it, Gumbel-max noise comes
from the op layer's counter hash of a key feed (``pool_ops._sample``,
ROADMAP Queue 3: it cannot reproduce ``jax.random``).

``jit_serve_steps`` is the reference's ``jax.jit`` pair: on a CUDA card
each step shape is a CUDA graph of one :class:`CaptureContext`
(``core/capture.py``), and the decode step donates its cache — the new
cache is written into the cache it was given, as ``donate_argnums=(1,)``
lets XLA do.  On the CPU, or under ``capture.disable_jit()``, the steps
run eagerly.  Cross-attention and encoder inputs arrive with the port's
cross-attention slice.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.capture import CaptureContext, jit_disabled
from repro_torch.core.device import resolve_device
from repro_torch.core.pytree import tree_leaves
from repro_torch.models import model as M
from repro_torch.serve.scheduler.pool_ops import _sample


def reject_side_inputs(cross_states, frontend_embeds=None) -> None:
    if cross_states is not None or frontend_embeds is not None:
        raise NotImplementedError(
            "cross_states / frontend_embeds (VLM and audio families) arrive "
            "with the port's cross-attention slice")


def build_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, tokens, *, cross_states=None,
                     frontend_embeds=None):
        reject_side_inputs(cross_states, frontend_embeds)
        with torch.no_grad():
            logits, cache = M.prefill(cfg, params, tokens, max_len)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            cache["len"] = torch.full((), tokens.shape[1], dtype=torch.int32,
                                      device=tokens.device)
        return next_tok, cache
    return prefill_step


def build_decode_step(cfg: ModelConfig, temperature: float = 0.0):
    def decode_step(params, cache, tokens, rng=None, *, cross_states=None):
        reject_side_inputs(cross_states)
        with torch.no_grad():
            logits, cache = M.decode_step(cfg, params, cache, tokens)
            next_tok = _sample(logits, temperature, rng)
        return next_tok[:, None], cache
    return decode_step


def _donating(decode, params, cache, tokens, *rng):
    """``decode`` with its new cache written into ``cache``'s tensors,
    which it returns in its place."""
    tok, new = decode(params, cache, tokens, *rng)
    for dst, src in zip(tree_leaves(cache), tree_leaves(new)):
        if src is not dst:
            dst.copy_(src)
    return tok, cache


def jit_serve_steps(cfg: ModelConfig, max_len: int, temperature: float = 0.0,
                    donate_cache: bool = True, device=None):
    """-> (prefill, decode): ``prefill(params, tokens)`` and ``decode(params,
    cache, tokens[, rng])``.  On a CUDA card (``device=None`` is the card)
    both are CapturedFns of one context, ``decode.ctx``."""
    prefill = build_prefill_step(cfg, max_len)
    decode = build_decode_step(cfg, temperature)
    if donate_cache:
        decode = functools.partial(_donating, decode)
    dev = resolve_device(device)
    if dev.type != "cuda" or jit_disabled():
        return prefill, decode
    ctx = CaptureContext(dev)
    return (ctx.wrap(prefill),
            ctx.wrap(decode, donate=(1,) if donate_cache else ()))
