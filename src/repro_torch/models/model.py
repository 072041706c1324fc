"""Model entry points: init, parameter counts, cache management and the
serve-path wrappers (prefill / one decode step) of every family: the
decoder-only attention, MoE, SSM and RG-LRU stacks, the VLM (vision
states as ``cross_states``) and Whisper (``frontend_embeds`` encoded
first)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import tree_leaves
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import constrain


def init_params(cfg: ModelConfig, generator=None, *, device=None):
    """Random parameters on ``device`` (default: the CUDA card; raises
    without one unless ``device="cpu"``) from ``generator``."""
    return T.init_params(cfg, generator, device=device)


def abstract_params(cfg: ModelConfig):
    """The parameter tree with shapes and dtypes only (tensors on the
    ``meta`` device): full-size configs cost no memory."""
    return T.init_params(cfg, device="meta")


def param_count(cfg_or_params) -> int:
    """Parameters of a config (counted on :func:`abstract_params`) or of
    a parameter tree."""
    tree = (abstract_params(cfg_or_params)
            if isinstance(cfg_or_params, ModelConfig) else cfg_or_params)
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: top_k + shared experts only)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    f = cfg.moe_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * f
    n_blocks = cfg.n_pattern_blocks * sum(
        cfg.block_pattern.count(k) for k in ("moe", "ssd_moe"))
    inactive = n_blocks * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive


# ==========================================================================
# KV / recurrent cache
# ==========================================================================

def _slot_cache(cfg, kind: str, nb: Optional[int], batch: int, max_len: int,
                device=None):
    """Cache pytree for one pattern slot; leading nb axis when stacked.
    A ``cross`` block has none: its K/V come from the states each step."""
    if kind == "cross":
        return None
    if kind not in T.KINDS or kind == "enc_attn":
        raise ValueError(f"no decoder cache for block kind {kind!r}")
    dt = getattr(torch, cfg.dtype)

    def zeros(*s, dtype=dt):
        shp = (nb,) + s if nb is not None else s
        return torch.zeros(shp, dtype=dtype, device=device)

    if kind in T.SSD_KINDS:
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        dc = H * P + 2 * N                      # conv runs over (x, B, C)
        # recurrent state kept in f32 for numerical stability
        return {"conv": zeros(batch, cfg.conv_kernel - 1, dc),
                "ssm": zeros(batch, H, P, N, dtype=torch.float32)}
    if kind == "rglru":
        dr = cfg.rglru_width
        return {"conv": zeros(batch, cfg.conv_kernel - 1, dr),
                "h": zeros(batch, dr, dtype=torch.float32)}
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    return {"k": zeros(batch, max_len, Hkv, D),
            "v": zeros(batch, max_len, Hkv, D)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Dense per-row cache; ``len`` is the host-side fill length (an int:
    every row of a lock-step batch is at the same fill)."""
    nb = cfg.n_pattern_blocks
    return {
        "layers": [_slot_cache(cfg, kind, nb, batch, max_len, device)
                   for kind in cfg.block_pattern],
        "extra": [_slot_cache(cfg, kind, None, batch, max_len, device)
                  for kind in cfg.extra_blocks],
        "len": 0,
    }


# ==========================================================================
# Serve-path entry points
# ==========================================================================

def prefill(cfg: ModelConfig, params, tokens, max_len: int, *,
            cross_states=None, frontend_embeds=None):
    """tokens [B, S] -> (last-position logits [B, vocab], cache).
    Whisper's ``frontend_embeds`` are encoded into ``cross_states``."""
    if cfg.enc_layers and frontend_embeds is not None:
        cross_states = T.encode(cfg, params, frontend_embeds)
    B, S = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, B, max_len, dev)
    x = T.embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=dev)[None]
    x, cache = T.run_stack(cfg, params, x, positions=positions, caches=cache,
                           cross_states=cross_states)
    x = T._norm(cfg, params["final_norm"], x[:, -1:])
    return constrain(T.head_logits(cfg, params, x[:, 0]), "batch",
                     "vocab"), cache


def decode_step(cfg: ModelConfig, params, cache, tokens, *,
                cross_states=None):
    """One decode step: tokens [B, 1] -> (logits [B, vocab], new cache).
    ``cross_states``: the VLM's vision states or Whisper's encoder states
    (``T.encode``), re-projected by every cross-attention."""
    x = T.embed_tokens(cfg, params, tokens)
    positions = cache["len"] + torch.arange(1, device=x.device)[None]
    x, cache = T.run_stack(cfg, params, x, positions=positions, caches=cache,
                           cross_states=cross_states)
    x = T._norm(cfg, params["final_norm"], x)
    return constrain(T.head_logits(cfg, params, x[:, 0]), "batch",
                     "vocab"), cache


forward = T.forward
