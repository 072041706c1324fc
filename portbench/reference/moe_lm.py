"""Plain reference of the MoE language model's forward (deepseek-moe).

The model as the port defines it (departures from the published model
are listed in ``configs/deepseek-moe-16b.json``): embedding; per layer
``x += attention(rmsnorm(x))`` (causal, rotary positions over the two
halves of each head, softmax scale D^-1/2) and ``x += moe(rmsnorm(x))``,
where the router's float32 logits pick each token's top-k experts (ties
to the lower index), their softmax over those k gives the weights, each
expert is a SwiGLU, the capacity rule keeps the first
``max(8, min(int(capacity_factor * T * k / E), T))`` of an expert's tokens
in (token, choice) order, and the shared experts are one SwiGLU of their
summed width; then the final rmsnorm and the output head.

It runs layer after layer over a batch of whole sequences, each a
sequence of its own (no padding, no cache), casting one layer's weights
to float32 at a time, so that it fits on a card beside the weights: plain
float32 PyTorch with TF32 off, or the ``fp8`` control of ``lowp.Prec``.
It imports nothing of the port and takes only the weights and tokens the
benchmark made."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.lowp import Prec, strict_f32


def rmsnorm(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + scale)


def rope(x, theta: float):
    """x [T, H, D] at positions 0..T-1."""
    T, _, D = x.shape
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, device=x.device,
                                         dtype=torch.float32) / half)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(h, p, m, pr: Prec):
    T = h.shape[0]
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = rope(pr.mm(h, p["attn.wq"]).reshape(T, H, D), m["rope_theta"])
    k = rope(pr.mm(h, p["attn.wk"]).reshape(T, Hkv, D), m["rope_theta"])
    v = pr.mm(h, p["attn.wv"]).reshape(T, Hkv, D)
    k = k.repeat_interleave(H // Hkv, 1)
    v = v.repeat_interleave(H // Hkv, 1)
    s = torch.einsum("qhd,khd->hqk", pr.q(q), pr.q(k)) * D ** -0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, -torch.inf), -1)
    o = torch.einsum("hqk,khd->qhd", pr.q(a), pr.q(v)).reshape(T, H * D)
    return pr.mm(o, p["attn.wo"])


def swiglu(x, wg, wu, wd, pr: Prec):
    return pr.mm(F.silu(pr.mm(x, wg)) * pr.mm(x, wu), wd)


def moe(h, p, m, pr: Prec):
    T = h.shape[0]
    E, K = m["n_experts"], m["top_k"]
    logits = pr.mm(h, p["moe.w_router"])
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    w, ids = torch.softmax(vals[:, :K], -1), ids[:, :K]
    C = max(8, min(int(m["capacity_factor"] * T * K / E), T))
    flat = ids.reshape(-1)                                  # (token, k) order
    onehot = F.one_hot(flat, E)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    keep = (pos < C).reshape(T, K)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, kk = torch.nonzero((ids == e) & keep, as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], p["moe.w_gate"][e], p["moe.w_up"][e],
                       p["moe.w_down"][e], pr)
            out.index_add_(0, tok, y * w[tok, kk][:, None])
    return out + swiglu(h, p["moe.shared.w_gate"], p["moe.shared.w_up"],
                        p["moe.shared.w_down"], pr)


def logits(weights: Dict[str, torch.Tensor], config: dict,
           seqs: List[torch.Tensor], prec: str = "f32") -> List[torch.Tensor]:
    """Float32 logits [T, vocab] at every position of each token sequence
    (``weights``: path -> tensor in the port's stacked layout)."""
    strict_f32()
    pr = Prec(prec)
    m = config["model"]
    emb = weights["embed"]
    xs = [emb[s.long()].float() for s in seqs]
    stacked = {k[len("blocks.0."):]: v for k, v in weights.items()
               if k.startswith("blocks.0.")}
    for i in range(m["n_layers"]):
        p = {k: v[i].float() for k, v in stacked.items()}
        for j, x in enumerate(xs):
            x = x + attention(rmsnorm(x, p["norm1.scale"]), p, m, pr)
            xs[j] = x + moe(rmsnorm(x, p["norm2.scale"]), p, m, pr)
        del p
    head = weights["lm_head"].float()
    out = [pr.mm(rmsnorm(x, weights["final_norm.scale"].float()), head.t())
           for x in xs]
    del head
    return out
