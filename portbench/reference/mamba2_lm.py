"""Plain reference of the mamba2 language model's training step.

The model as the port defines it (each departure from the published
Mamba-2 is listed in ``configs/mamba2-130m.json``): embedding, then per
layer ``x + block(rmsnorm(x))`` where the block is the input projection
to (z, x, B, C, dt), dt = softplus(dt + dt_bias), a causal depthwise conv
of width K over (x, B, C) and SiLU, the SSD scan with A = -exp(a_log)
(chunked: the quadratic form inside a chunk, a recurrence over chunk
states), the gate y * silu(z) and the output projection; then the final
rmsnorm and the tied output head.  The loss is the mean next-token
cross-entropy plus ``z_loss`` times the mean squared log-partition; the
optimizer is AdamW with global-norm clipping, linear warm-up and cosine
decay, and decoupled weight decay on float32 masters.

Plain float32 PyTorch (TF32 off), or the ``fp8`` control of
``lowp.Prec``; each layer is recomputed in the backward
(``torch.utils.checkpoint``) and the loss is taken in row blocks, so the
whole step fits beside nothing else on one card.  It imports nothing of
the port and takes only the weights and batches the benchmark made."""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.lowp import Prec, strict_f32

CHUNK = 64


def rmsnorm(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + scale)


def ssd(x, dt, A, Bm, Cm, pr: Prec, Q: int = CHUNK):
    """y[t] = sum_{s<=t} C_t . B_s * exp(sum_{s<r<=t} dt_r A) * dt_s x_s,
    per head, computed by chunks.  x [b,S,h,p], dt [b,S,h], A [h],
    Bm/Cm [b,S,n]."""
    b, S, h, p = x.shape
    n = Bm.shape[-1]
    while S % Q:
        Q //= 2
    nc = S // Q
    a = (dt * A).reshape(b, nc, Q, h).permute(0, 1, 3, 2)        # [b,c,h,Q]
    cs = torch.cumsum(a, -1)
    u = pr.q(x.reshape(b, nc, Q, h, p) * dt.reshape(b, nc, Q, h, 1))
    Br = pr.q(Bm.reshape(b, nc, Q, n))
    Cr = pr.q(Cm.reshape(b, nc, Q, n))
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal, cs[..., :, None] - cs[..., None, :],
                                  -math.inf))                     # [b,c,h,Q,Q]
    scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    y = torch.einsum("bchqk,bckhp->bcqhp", scores[:, :, None] * decay, u)
    to_end = torch.exp(cs[..., -1:] - cs)                          # [b,c,h,Q]
    states = torch.einsum("bckn,bchk,bckhp->bchpn", Br, to_end, u)
    hcur = torch.zeros(b, h, p, n, device=x.device, dtype=states.dtype)
    prev = []
    for c in range(nc):
        prev.append(hcur)
        hcur = hcur * torch.exp(cs[:, c, :, -1])[..., None, None] + states[:, c]
    prev = pr.q(torch.stack(prev, 1))                              # [b,c,h,p,n]
    y = y + torch.einsum("bcqn,bchpn,bchq->bcqhp", Cr, prev, torch.exp(cs))
    return y.reshape(b, S, h, p)


def block(x, p, m, pr: Prec):
    H, P, N, K = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"], \
        m["conv_kernel"]
    di = H * P
    h = rmsnorm(x, p["norm1.scale"])
    zx = pr.mm(h, p["ssd.w_in"])
    z, xin, Bm, Cm, dt = torch.split(zx, [di, di, N, N, H], -1)
    dt = F.softplus(dt + p["ssd.dt_bias"])
    ci = torch.cat([xin, Bm, Cm], -1).transpose(1, 2)              # [b,dc,S]
    ci = F.pad(ci, (K - 1, 0))
    w = pr.q(p["ssd.w_conv"])                                      # [dc,K]
    conv = F.silu(F.conv1d(pr.q(ci), w[:, None, :],
                           groups=w.shape[0])).transpose(1, 2)
    xc, Bc, Cc = torch.split(conv, [di, N, N], -1)
    A = -torch.exp(p["ssd.a_log"])
    y = ssd(xc.reshape(*xc.shape[:2], H, P), dt, A, Bc, Cc, pr)
    y = y.reshape(*y.shape[:2], di) * F.silu(z)
    return x + pr.mm(y, p["ssd.w_out"])


def _loss_rows(xf, head, labels, pr_name, z_loss):
    pr = Prec(pr_name)
    logits = pr.mm(xf, head.t())
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.stack([(lse - ll).sum(), (lse * lse).sum()])


def loss_fn(w: Dict[str, torch.Tensor], m: dict, tokens, labels, pr: Prec,
            z_loss: float, rows: int = 2):
    L = m["n_layers"]
    x = w["embed"][tokens.long()]
    for i in range(L):
        p = {k[len("blocks.0."):]: v[i] for k, v in w.items()
             if k.startswith("blocks.0.")}
        x = checkpoint(block, x, p, m, pr, use_reentrant=False)
    xf = rmsnorm(x, w["final_norm.scale"])
    tot = torch.zeros(2, device=x.device)
    for r in range(0, xf.shape[0], rows):
        tot = tot + checkpoint(_loss_rows, xf[r:r + rows], w["embed"],
                               labels[r:r + rows], pr.name, z_loss,
                               use_reentrant=False)
    n = tokens.numel()
    return tot[0] / n + z_loss * tot[1] / n


def lr_at(o: dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    frac = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return o["lr"] * warm * frac


def train(weights: Dict[str, torch.Tensor], config: dict, batches: List,
          opt: dict, z_loss: float, prec: str = "f32", grad_step: int = 0,
          change_from: int = 0) -> dict:
    """``len(batches)`` AdamW steps from ``weights`` (path -> tensor, any
    dtype; taken as float32 masters).  Returns the loss of each step, each
    leaf's clipped gradient at step ``grad_step`` (its norm; steps count
    from 0) and each leaf's change over the steps from ``change_from`` to
    the last (its norm)."""
    strict_f32()
    pr = Prec(prec)
    m = config["model"]
    master = {k: v.detach().float().clone() for k, v in weights.items()}
    start = None
    mom = {k: torch.zeros_like(v) for k, v in master.items()}
    vel = {k: torch.zeros_like(v) for k, v in master.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    losses, grad = [], None
    for i, (tokens, labels) in enumerate(batches):
        step = i + 1
        if i == change_from:
            start = {k: v.clone() for k, v in master.items()}
        w = {k: v.requires_grad_(True) for k, v in
             ((k, v.detach().clone()) for k, v in master.items())}
        loss = loss_fn(w, m, tokens, labels, pr, z_loss)
        grads = torch.autograd.grad(loss, list(w.values()))
        g = dict(zip(w.keys(), grads))
        losses.append(float(loss.detach()))
        gnorm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
        sc = min(1.0, opt["clip_norm"] / (float(gnorm) + 1e-9))
        lr = lr_at(opt, step)
        if i == grad_step:
            grad = {k: float(x.double().norm()) * sc for k, x in g.items()}
        for k in master:
            gk = g[k].float() * sc
            mom[k] = b1 * mom[k] + (1 - b1) * gk
            vel[k] = b2 * vel[k] + (1 - b2) * gk * gk
            mh = mom[k] / (1 - b1 ** step)
            vh = vel[k] / (1 - b2 ** step)
            master[k] = master[k] - lr * (mh / (torch.sqrt(vh) + opt["eps"])
                                          + opt["weight_decay"] * master[k])
        del w, grads, g
    change = {k: float((master[k] - start[k]).double().norm())
              for k in master}
    return {"loss": losses, "grad": grad, "change": change}
