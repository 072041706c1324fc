"""RecurrentGemma (arXiv:2402.19427) recurrent block: temporal conv + RG-LRU.

The counterpart of the reference's ``models/rglru.py:rglru_block``.  Per
channel:

    r_t = sigmoid(W_a x_t + b_a)              (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)              (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)    (decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The state is float32.  A prefill (or a forward) runs the recurrence as a
log-depth scan over the sequence — ``ceil(log2 S)`` rounds of elementwise
ops, the counterpart of ``jax.lax.associative_scan`` — which multiplies
decays and never divides by them (no ``exp(-cumsum log a)`` form), so it
stays stable in f32 at any length.  Decode is the single recurrent update.
The reference has no Pallas kernel here, so neither does the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense

_C = 8.0


def rg_lru_scan(x_gated, a, h0=None):
    """h_t = a_t * h_{t-1} + x_gated_t for every t; x_gated/a: [B, S, D]
    (f32), h0: [B, D] or None (zeros).  Hillis-Steele: round k combines
    each position with the one 2^k before it, (A, X) <- (A' A, A X' + X)."""
    x, a = x_gated, a
    if h0 is not None:                  # fold the state into position 0
        x = torch.cat([x[:, :1] + a[:, :1] * h0[:, None], x[:, 1:]], 1)
    S, off = x.shape[1], 1
    while off < S:
        x = torch.cat([x[:, :off], a[:, off:] * x[:, :-off] + x[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return x


def _conv(ci, w, S: int):
    """Depthwise causal conv: out[:, s] = sum_k ci[:, s + k] * w[:, k],
    accumulated in f32, cast back to ci's dtype."""
    acc = None
    for k in range(w.shape[1]):
        term = ci[:, k:k + S].float() * w[:, k].float()
        acc = term if acc is None else acc + term
    return acc.to(ci.dtype)


def rglru_block(p, x, cfg, *, cache=None):
    """x: [B, S, d].  cache: None or dict(conv [B,K-1,dr], h [B,dr]).
    Returns (out [B, S, d], new cache or None)."""
    B, S, d = x.shape
    dr, K = cfg.rglru_width, cfg.conv_kernel

    xb = dense(x, p["w_in_x"])                  # [B,S,dr] linear branch
    yb = F.gelu(dense(x, p["w_in_y"]), approximate="tanh")   # gated branch

    # temporal conv (depthwise, causal)
    new_conv = None
    if cache is None:
        pad = torch.zeros((B, K - 1, dr), dtype=xb.dtype, device=x.device)
        ci = torch.cat([pad, xb], 1)
    else:
        ci = torch.cat([cache["conv"].to(xb.dtype), xb], 1)
        new_conv = ci[:, -(K - 1):]
    xc = _conv(ci, p["w_conv"], S)

    # RG-LRU
    r = torch.sigmoid(dense(xc, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(dense(xc, p["w_x"]) + p["b_x"])
    a = torch.exp(-_C * F.softplus(p["lam"].float()) * r)     # [B,S,dr] f32
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-6)) * (i * xc)
    a, gated = a.float(), gated.float()

    new_h = None
    if cache is None:
        h = rg_lru_scan(gated, a)
    elif S == 1:
        h1 = a[:, 0] * cache["h"].float() + gated[:, 0]
        h = h1[:, None]
        new_h = h1
    else:
        h = rg_lru_scan(gated, a, h0=cache["h"].float())
        new_h = h[:, -1]

    out = dense(h.to(x.dtype) * yb, p["w_out"])
    if cache is not None:
        return out, {"conv": new_conv, "h": new_h}
    return out, None
