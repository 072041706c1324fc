"""Serving steps: prefill, single-token decode and the encoder, captured
on the card.

The counterpart of the reference's ``serve/serve_step.py``.  ``prefill``
runs the model over a batch of same-length prompts into a fresh dense
cache and takes the greedy first token; ``decode`` is one new token
against that cache; ``encode`` runs Whisper's encoder over frame
embeddings once, so that prefill and every decode step read its states
as ``cross_states`` (the VLM passes its vision states there directly).
The cache's fill length ``len`` is an int32 0-d tensor on the device, as
it is an array in the reference, so every decode step of a batch has the
same shapes and one CUDA graph serves them all.

Sampling is greedy at temperature 0; above it, Gumbel-max noise comes
from the op layer's counter hash of a key feed (``pool_ops._sample``,
ROADMAP Queue 3: it cannot reproduce ``jax.random``).

``jit_serve_steps`` is the reference's ``jax.jit`` pair: on a CUDA card
each step shape is a CUDA graph of one :class:`CaptureContext`
(``core/capture.py``), and the decode step donates its cache — the new
cache is written into the cache it was given, as ``donate_argnums=(1,)``
lets XLA do.  On the CPU, or under ``capture.disable_jit()``, the steps
run eagerly.  A captured step takes its arguments by position
(``prefill(params, tokens, cross_states, frontend_embeds)``,
``decode(params, cache, tokens, rng, cross_states)``): the states are an
input of the graph, read in place while their address holds and copied
into a static buffer once it moves; a new shape captures a new graph.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.capture import CaptureContext, jit_disabled
from repro_torch.core.device import resolve_device
from repro_torch.core.pytree import tree_leaves
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serve.scheduler.pool_ops import _sample


def build_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, tokens, cross_states=None,
                     frontend_embeds=None):
        with torch.no_grad():
            logits, cache = M.prefill(cfg, params, tokens, max_len,
                                      cross_states=cross_states,
                                      frontend_embeds=frontend_embeds)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            cache["len"] = torch.full((), tokens.shape[1], dtype=torch.int32,
                                      device=tokens.device)
        return next_tok, cache
    return prefill_step


def build_decode_step(cfg: ModelConfig, temperature: float = 0.0):
    def decode_step(params, cache, tokens, rng=None, cross_states=None):
        with torch.no_grad():
            logits, cache = M.decode_step(cfg, params, cache, tokens,
                                          cross_states=cross_states)
            next_tok = _sample(logits, temperature, rng)
        return next_tok[:, None], cache
    return decode_step


def build_encode_step(cfg: ModelConfig):
    def encode_step(params, frontend_embeds):
        with torch.no_grad():
            return T.encode(cfg, params, frontend_embeds)
    return encode_step


def _donating(decode, params, cache, tokens, rng=None, cross_states=None):
    """``decode`` with its new cache written into ``cache``'s tensors,
    which it returns in its place."""
    tok, new = decode(params, cache, tokens, rng, cross_states)
    for dst, src in zip(tree_leaves(cache), tree_leaves(new)):
        if src is not dst:
            dst.copy_(src)
    return tok, cache


def jit_serve_steps(cfg: ModelConfig, max_len: int, temperature: float = 0.0,
                    donate_cache: bool = True, device=None):
    """-> (prefill, decode): ``prefill(params, tokens[, cross_states[,
    frontend_embeds]])`` and ``decode(params, cache, tokens[, rng[,
    cross_states]])``.  On a CUDA card (``device=None`` is the card) both
    are CapturedFns of one context, ``decode.ctx``."""
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


def jit_encode_step(cfg: ModelConfig, device=None, ctx=None):
    """-> ``encode(params, frontend_embeds)``: Whisper's encoder states.
    On a CUDA card a CapturedFn of ``ctx`` (default: a context of its
    own), so that it can share the serving steps' memory pool."""
    encode = build_encode_step(cfg)
    dev = resolve_device(device)
    if dev.type != "cuda" or jit_disabled():
        return encode
    return (ctx or CaptureContext(dev)).wrap(encode)
