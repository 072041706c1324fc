"""Plain reference of the granite-4.0-h hybrid language model's forward.

The published model (ibm-granite/granite-4.0-h-small, ``config.json``,
model_type ``granitemoehybrid``), cut to the layers its configuration
file keeps (``configs/granite-4.0-h-small.json`` lists the cut and every
departure): the embedding times ``embedding_multiplier``; per layer
``x += r * mixer(rmsnorm(x))`` and ``x += r * ffn(rmsnorm(x))`` with
``r = residual_multiplier``; then the final rmsnorm and the output head
(the embedding when ``tie_embeddings``), divided by ``logits_scaling``.
Every rmsnorm takes ``norm_eps`` (the published ``rms_norm_eps``) and
weights ``1 + scale``.

* The mixer of a ``mamba`` layer (a ``ssd_moe`` slot) is Mamba-2: the
  input projection to (z, x, B, C, dt); dt = softplus(dt + dt_bias); a
  causal depthwise conv of width K with its bias over (x, B, C), then
  SiLU; the SSD scan with A = -exp(a_log) (``mamba2_lm.ssd``, by chunks
  of 64); the D skip ``y += x * d_skip`` per head; the gated RMSNorm
  ``rmsnorm(y * silu(z))`` over the whole inner width (one group), in
  float32; the output projection.
* The mixer of an ``attention`` layer (a ``moe`` slot) is causal GQA with
  no positional encoding (NoPE) and softmax scale ``attn_scale`` (the
  published ``attention_multiplier``).
* Every layer's FFN is the MoE of ``moe_lm.moe``: float32 router logits,
  each token's top-k experts (ties to the lower index) weighted by the
  softmax over those k, SwiGLU experts, and the shared SwiGLU (its
  published width, written as the port's summed shared experts); with
  ``capacity_factor`` equal to the expert count no token is dropped.

Departures from the published model, all in the configuration file: the
cut to 20 layers followed by the head, an untied head (a tied one makes
the random-weight stack copy its input token), the ties of the router's
sort, and the scan's chunk of 64.  It runs layer after layer over a batch
of whole sequences, each its own (no padding, no cache), each product
casting its own weight operand to float32 (a layer's are never held in
float32 whole, so that it fits beside what the served program left):
plain float32 PyTorch with TF32 off, or the ``fp8`` control of
``lowp.Prec``.  It imports nothing of the
port and takes only the weights and tokens the benchmark made."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.lowp import Prec, strict_f32
from portbench.reference.mamba2_lm import CHUNK, ssd
from portbench.reference.moe_lm import moe


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + scale)


def attention(h, p, m, pr: Prec):
    """Causal GQA with no positions, scores scaled by ``attn_scale``;
    taken one key/value head's group of query heads at a time."""
    T = h.shape[0]
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    G = H // Hkv
    q = pr.q(pr.mm(h, p["attn.wq"]).reshape(T, Hkv, G, D))
    k = pr.q(pr.mm(h, p["attn.wk"]).reshape(T, Hkv, D))
    v = pr.q(pr.mm(h, p["attn.wv"]).reshape(T, Hkv, D))
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(T, Hkv, G, D, dtype=q.dtype, device=h.device)
    for j in range(Hkv):
        s = torch.einsum("qgd,kd->gqk", q[:, j], k[:, j]) * m["attn_scale"]
        a = torch.softmax(s.masked_fill(~causal, -torch.inf), -1)
        out[:, j] = torch.einsum("gqk,kd->qgd", pr.q(a), v[:, j])
        del s, a
    return pr.mm(out.reshape(T, H * D), p["attn.wo"])


def mixer(h, p, m, pr: Prec):
    """Mamba-2 over one sequence h [T, d]."""
    T = h.shape[0]
    H, P, N, K = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"], \
        m["conv_kernel"]
    di = H * P
    z, xin, Bm, Cm, dt = torch.split(pr.mm(h, p["ssd.w_in"]),
                                     [di, di, N, N, H], -1)
    f = h.dtype                 # the weights' non-product uses, cast
    dt = F.softplus(dt + p["ssd.dt_bias"].to(f))
    ci = F.pad(torch.cat([xin, Bm, Cm], -1).t()[None], (K - 1, 0))
    w = pr.q(p["ssd.w_conv"])                                      # [dc,K]
    conv = F.silu(F.conv1d(pr.q(ci), w[:, None, :], p["ssd.b_conv"].to(f),
                           groups=w.shape[0]))[0].t()              # [T,dc]
    xc, Bc, Cc = torch.split(conv, [di, N, N], -1)
    xc = xc.reshape(T, H, P)
    A = -torch.exp(p["ssd.a_log"].to(f))
    # zeros after the last position (dt = 0 there) fill the last chunk:
    # the scan is causal, so they change no earlier output
    ext = [F.pad(t, (0, 0) * (t.ndim - 1) + (0, -T % CHUNK))
           for t in (xc, dt, Bc, Cc)]
    y = ssd(*(t[None] for t in ext[:2]), A, *(t[None] for t in ext[2:]),
            pr, Q=CHUNK)[0, :T]                                    # [T,H,P]
    y = (y + xc * p["ssd.d_skip"].to(f)[:, None]).reshape(T, di)
    y = rmsnorm(y * F.silu(z), p["ssd.norm.scale"].to(f), m["norm_eps"])
    return pr.mm(y, p["ssd.w_out"])


def logits(weights: Dict[str, torch.Tensor], config: dict,
           seqs: List[torch.Tensor], prec: str = "f32") -> List[torch.Tensor]:
    """Float32 logits [T, vocab] at every position of each token sequence
    (``weights``: path -> tensor in the port's stacked layout)."""
    strict_f32()
    pr = Prec(prec)
    m = config["model"]
    eps, r = m["norm_eps"], m["residual_multiplier"]
    pattern = m["block_pattern"]
    emb = weights["embed"]
    xs = [emb[s.long()].float() * m["embedding_multiplier"] for s in seqs]
    for i in range(m["n_layers"] // len(pattern)):
        for slot, kind in enumerate(pattern):
            # the layer's weights as they are: each product casts its own
            # operands (Prec.q), so no layer is held in float32 whole
            pre = f"blocks.{slot}."
            p = {k[len(pre):]: v[i] for k, v in weights.items()
                 if k.startswith(pre)}
            mix = attention if kind == "moe" else mixer
            for j, x in enumerate(xs):
                x = x + r * mix(rmsnorm(x, p["norm1.scale"].float(), eps), p,
                                m, pr)
                xs[j] = x + r * moe(rmsnorm(x, p["norm2.scale"].float(), eps),
                                    p, m, pr)
            del p
    head = pr.q(weights["embed" if m["tie_embeddings"] else "lm_head"]).t()
    fin = weights["final_norm.scale"].float()
    out = [torch.matmul(pr.q(rmsnorm(x, fin, eps)), head)
           / m["logits_scaling"] for x in xs]
    del head
    return out
