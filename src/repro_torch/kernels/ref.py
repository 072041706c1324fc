"""Plain PyTorch versions of the kernels (the allclose ground truth).

Each function computes exactly what its kernel computes, with f32
accumulation and the result cast back to the input dtype.  The CPU tests
run them, and ``chip_smoke.py`` holds every kernel against them on the
card.  The wrappers in this package call them only for tensors that lie
on the CPU — the caller asked for the CPU.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,H,Sq,D]; k/v: [B,Hkv,Skv,D]; GQA by head grouping.
    Returns [B,H,Sq,D] (f32 accumulation, cast back to q.dtype)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    qr = q.reshape(B, Hkv, G, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qr, k.float()) * (D ** -0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def ref_paged_attention(q, kp, vp, bt, valid, *, window: int = 0):
    """Paged decode: q [B,1,Hq,D]; kp/vp [num_blocks,bs,Hkv,D];
    bt [B,nbps]; valid [B].  Gathers each row's blocks back into logical
    order and runs a masked dense softmax — the ground truth the kernel's
    block-streamed online softmax must match."""
    B, _, Hq, D = q.shape
    Hkv = kp.shape[2]
    G = Hq // Hkv
    bt = bt.long()
    k = kp[bt].reshape(B, -1, Hkv, D).float()       # [B,Smax,Hkv,D]
    v = vp[bt].reshape(B, -1, Hkv, D).float()
    qr = q.reshape(B, Hkv, G, D).float() * (D ** -0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qr, k)
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    vl = valid.reshape(-1, 1)
    ok = pos < vl
    if window:
        ok &= pos >= vl - window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def ref_rmsnorm(x, g, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * (1.0 + g.float())).to(x.dtype)


# The shapes and tolerances at which the SSD-scan kernel is held against
# ref_ssd and the chunked math (tests and chip_smoke.py): the reference's
# tests/test_kernels.py:48-54, a prime length (the reference's chunk
# halves to 1) and a length below the chunk.
SSD_SWEEP = [
    # (B, S, H, P, N, chunk)
    (1, 64, 2, 16, 16, 16),
    (2, 128, 4, 32, 32, 32),
    (1, 128, 2, 64, 16, 64),
    (1, 96, 2, 16, 32, 32),
    (1, 37, 2, 16, 16, 16),
    (2, 20, 2, 16, 16, 64),
]
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def ref_ssd(x, dt, A, Bm, Cm, *, return_final: bool = False):
    """Sequential SSD recurrence (the literal state-space semantics).

    x: [B,S,H,P]; dt: [B,S,H]; A: [H]; Bm/Cm: [B,S,N] -> y [B,S,H,P] in
    x's dtype, with the f32 state h [B,H,P,N] carried token by token;
    ``return_final`` also returns the state after the last token."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), Bm.float(), Cm.float()
    A = A.float()
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t] * A[None, :])                      # [B,H]
        upd = torch.einsum("bn,bh,bhp->bhpn", bf[:, t], dtf[:, t], xf[:, t])
        h = h * da[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, t], h))
    y = torch.stack(ys, 1).to(x.dtype)
    return (y, h) if return_final else y
