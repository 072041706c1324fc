"""Model entry points: init, cache management and the serve-path wrappers
(prefill / one decode step) of the decoder-only attention and SSM
families."""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import tree_leaves
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_params(cfg: ModelConfig, generator=None, *, device=None):
    """Random parameters on ``device`` (default: the CUDA card; raises
    without one unless ``device="cpu"``) from ``generator``."""
    return T.init_params(cfg, generator, device=device)


def param_count(params) -> int:
    return sum(math.prod(x.shape) for x in tree_leaves(params))


# ==========================================================================
# KV / recurrent cache
# ==========================================================================

def _slot_cache(cfg, kind: str, nb: Optional[int], batch: int, max_len: int,
                device=None):
    """Cache pytree for one pattern slot; leading nb axis when stacked."""
    if kind not in T.PORTED_KINDS:
        raise NotImplementedError(f"{kind!r} caches arrive in a later "
                                  f"slice of the port")
    dt = getattr(torch, cfg.dtype)

    def zeros(*s, dtype=dt):
        shp = (nb,) + s if nb is not None else s
        return torch.zeros(shp, dtype=dtype, device=device)

    if kind == "ssd":
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        dc = H * P + 2 * N                      # conv runs over (x, B, C)
        # recurrent state kept in f32 for numerical stability
        return {"conv": zeros(batch, cfg.conv_kernel - 1, dc),
                "ssm": zeros(batch, H, P, N, dtype=torch.float32)}
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

def prefill(cfg: ModelConfig, params, tokens, max_len: int):
    """tokens [B, S] -> (last-position logits [B, vocab], cache)."""
    B, S = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, B, max_len, dev)
    x = L.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    positions = torch.arange(S, device=dev)[None]
    x, cache = T.run_stack(cfg, params, x, positions=positions, caches=cache)
    x = T._norm(cfg, params["final_norm"], x[:, -1:])
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(x[:, 0], head), cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step: tokens [B, 1] -> (logits [B, vocab], new cache)."""
    x = L.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    positions = cache["len"] + torch.arange(1, device=x.device)[None]
    x, cache = T.run_stack(cfg, params, x, positions=positions, caches=cache)
    x = T._norm(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(x[:, 0], head), cache


forward = T.forward
