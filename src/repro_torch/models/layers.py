"""Shared neural-net building blocks (plain functions on tensors, params as
nested dicts of tensors — the engine threads them as Variables leaf by
leaf)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import (constrain, gathered, is_dtensor,
                                           replicated)


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean(torch.square(x - mu), -1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


def dense(x, w, b=None):
    w = gathered(w)
    if x.dtype != w.dtype:              # jnp.einsum's type promotion
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------

def rope(x, positions, theta: float = 500000.0):
    """x: [..., S, H, D]; positions: [..., S] (broadcastable)."""
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., :, None].float() * freqs          # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def _hidden_names(ndim):
    return ("batch",) + (None,) * (ndim - 2) + ("d_ff",)


def mlp_swiglu(p, x):
    """Llama-family gated MLP: down(silu(gate(x)) * up(x))."""
    h = F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    h = constrain(h, *_hidden_names(h.ndim))
    return dense(h, p["w_down"])


def embed(table, ids):
    if is_dtensor(table):
        # under a mesh: the table read whole, by DTensor's
        # embedding rule (its rules for the indexing's backward with
        # sharded ids, and for a vocab-sharded table's masked partial
        # meeting the gradient's partial sum, fail in the versions at
        # hand)
        return F.embedding(ids.long(), replicated(table))
    return table[ids.long()]


def unembed(x, table):
    """Logits projection; table [vocab, d] (tied) -> [..., vocab]."""
    return torch.matmul(x, gathered(table).t())


# --------------------------------------------------------------------------
# Initializers (explicit torch.Generator; the leading ``stack`` axis holds
# the per-layer copies of a scanned pattern slot)
# --------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape, dtype, scale: float):
    """Normal truncated to [-2, 2], times ``scale``; drawn in f32 on the
    generator's device, then cast."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if t.device.type != "meta":             # meta tensors hold shapes only
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def he_init(gen: torch.Generator, shape, dtype, stack=()):
    """He-scaled truncated normal over ``stack + shape``; the fan-in is
    ``shape[0]``, as for one unstacked weight."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    return trunc_normal(gen, tuple(stack) + tuple(shape), dtype,
                        (2.0 / max(fan_in, 1)) ** 0.5)
