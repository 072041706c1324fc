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


# The shapes and tolerances at which the attention kernels are held
# against their plain versions and the JAX reference (tests and
# chip_smoke.py).  Flash: tests/test_kernels.py:17-25 (ATTN_SWEEP), plus
# the causal Sq != Skv case the reference's test skips (positions count
# from 0 on both axes), and the cases the 64-row / 64-key tiles make
# risky.  ATTN_SWEEP holds what the reference's Pallas kernel runs in
# interpret mode on the CPU at a test's pace; CARD_ONLY_ATTN holds ragged
# shapes whose interpret-mode grids (blocks halved to 1 or 2 rows) are too
# slow there, head dims between the instantiated ones (80 and 96 run in
# the D = 128 kernels, their extra columns masked), and whisper-small's
# two attentions with no mask, cut to few heads: the encoder's over its
# 1500 frames and the decoder's cross-attention (128 queries, 1500 keys).
ATTN_SWEEP = [
    # (B, H, Hkv, Sq, Skv, D, causal, window)
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 8, 2, 256, 256, 64, True, 0),          # GQA
    (1, 4, 1, 128, 128, 128, True, 0),         # MQA
    (2, 4, 4, 128, 128, 64, False, 0),         # bidirectional
    (1, 4, 2, 256, 256, 64, True, 64),         # sliding window
    (1, 2, 2, 64, 256, 64, False, 0),          # cross-shape (Sq != Skv)
    (1, 2, 2, 64, 256, 64, True, 0),           # causal, Sq != Skv
    (1, 2, 1, 64, 130, 32, False, 0),          # Skv not a multiple of 64
    (1, 2, 2, 128, 65, 64, False, 0),          # one key in the last tile
    (1, 4, 2, 1, 130, 64, False, 0),           # Sq = 1 (a decode row)
    (1, 2, 2, 1, 64, 64, True, 0),             # Sq = 1 causal: key 0 only
    (1, 2, 2, 128, 128, 64, True, 1),          # window 1: its own key
    (1, 2, 2, 64, 128, 16, True, 0),           # D 16, causal Sq < Skv
    (1, 2, 1, 128, 64, 32, True, 0),           # D 32, causal Sq > Skv
    (1, 10, 1, 128, 128, 256, True, 32),       # D 256, GQA 10/1, window
]
CARD_ONLY_ATTN = [
    (2, 2, 1, 100, 37, 32, False, 16),         # ragged; rows past every key
    (1, 2, 2, 77, 77, 16, True, 0),            # ragged causal
    (1, 2, 2, 65, 130, 64, True, 0),           # ragged both, causal
    (2, 4, 2, 200, 200, 64, True, 100),        # ragged, window > a tile
    (1, 2, 2, 1, 1, 128, True, 0),             # one query, one key
    (1, 2, 2, 130, 130, 128, True, 1),         # window 1, ragged
    (1, 2, 1, 100, 37, 128, True, 16),         # causal rows past every key
    (1, 10, 1, 2100, 2100, 256, True, 2048),   # recurrentgemma-2b heads,
                                               # its window bites, ragged
    (2, 4, 2, 130, 77, 256, False, 0),         # D 256, ragged, Sq > Skv
    (2, 4, 2, 130, 200, 80, True, 0),          # D 80, causal, ragged
    (1, 2, 1, 100, 100, 80, True, 32),         # D 80, window
    (1, 4, 4, 64, 300, 96, False, 0),          # D 96, Sq != Skv
    (2, 2, 2, 77, 77, 96, True, 16),           # D 96, ragged, window
    (1, 2, 2, 1500, 1500, 64, False, 0),       # whisper encoder
    (2, 2, 2, 128, 1500, 64, False, 0),        # whisper cross-attention
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# Paged decode: (B, Hkv, G, D, bs, nbps, nblocks, valid) with each window
# of PAGED_WINDOWS.  The tests/test_paged.py shape with G in {1, 4}, a
# wider one with ragged rows and trash tails, and shapes whose split plan
# (kernels/paged_attention.split_plan) cuts rows into multi-block splits:
# valid = 1, valid on a split boundary, a full row (nbps * bs), windows
# shorter and longer than a split, G in {1, 2, 4, 8}, bs in {8, 16, 32},
# and a one-block table, whose single split writes the output itself;
# then the registry's other groups (5: qwen2.5-14b, 6: mixtral-8x22b, 10
# with D 256: recurrentgemma-2b) with a row that window 100 cuts, groups
# that run padded (3 in 4, 7 in 8, 12 in 16) and 16 at D 256, and head dims
# between the instantiated ones (80 and 96, in the D = 128 kernels).
# PAGED_SERVING is the serving path's own shape (llama3-8b heads, 8 slots
# x 512 tokens in 16-token pages), PAGED_LONG a longer cache.
PAGED_SWEEP = [
    (3, 2, 1, 16, 8, 4, 9, [5, 9, 16]),
    (3, 2, 4, 16, 8, 4, 9, [5, 9, 16]),
    (4, 2, 8, 64, 16, 4, 12, [1, 16, 17, 40]),
    (8, 8, 2, 16, 16, 32, 257, [1, 64, 65, 128, 300, 511, 512, 17]),
    (8, 8, 1, 16, 8, 16, 129, [1, 16, 17, 128, 33, 64, 100, 127]),
    (4, 2, 8, 32, 32, 8, 33, [1, 32, 33, 256]),
    (2, 2, 4, 32, 16, 1, 3, [5, 16]),            # one split: no combine
    (2, 2, 5, 32, 8, 4, 9, [5, 30]),
    (2, 2, 6, 64, 16, 8, 17, [17, 120]),
    (2, 1, 10, 256, 16, 8, 17, [40, 128]),
    (1, 2, 7, 16, 8, 4, 5, [20]),
    (1, 1, 16, 256, 16, 4, 5, [60]),
    (2, 1, 3, 256, 8, 2, 5, [3, 16]),
    (1, 1, 12, 64, 8, 2, 3, [10]),
    (2, 2, 4, 80, 16, 4, 9, [5, 50]),
    (3, 1, 5, 96, 8, 8, 25, [1, 33, 64]),
]
PAGED_WINDOWS = (0, 6, 100)
PAGED_SERVING = (8, 8, 4, 128, 16, 32, 257,
                 [1, 17, 100, 255, 256, 300, 444, 512])
PAGED_LONG = (8, 8, 4, 128, 16, 128, 1025,
              [1, 100, 500, 1000, 1500, 1800, 2047, 2048])


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


# The shapes at which the rmsnorm kernels are held against ref_rmsnorm and
# the JAX reference (tests and chip_smoke.py), as (x's shape, offset): x
# is a contiguous view starting ``offset`` elements into a 16-byte aligned
# buffer (offset 1: an unaligned view).  The reference test's shapes
# (tests/test_kernels.py:77), then shapes that reach both kernels of
# csrc/rmsnorm.cu: the register kernel at d = 24 (one warp a row), 1000
# (a row that does not fill its threads), 4096 (a single row, 4096 rows
# and the co-execution path's [4, 512, 4096]) and 8192 (8 packs a thread);
# the generic kernel at a ragged d = 100, d = 16384 and an unaligned view.
RMS_SWEEP = [
    ((4, 128), 0), ((2, 16, 256), 0), ((64, 512), 0),
    ((3, 24), 0), ((7, 1000), 0), ((1, 4096), 0), ((4096, 4096), 0),
    ((4, 512, 4096), 0), ((2, 8192), 0),
    ((3, 100), 0), ((2, 16384), 0), ((5, 4096), 1),
]
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def ref_rmsnorm(x, g, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * (1.0 + g.float())).to(x.dtype)


# The shapes at which the causal_conv kernels are held against their plain
# versions (tests and chip_smoke.py): (B, S, dc, K, width, offset, bias,
# window), x the columns offset .. offset + dc of a [B, S, width] buffer.
# mamba2-130m's training shape (the (x, B, C) columns of the
# in-projection's 3352), granite-4.0-h-small's longest padded prefill (B 1,
# dc 8448 of 16768, bias and window), S no multiple of a CTA's rows, S
# below K-1, K 2 and 3, rows that are not 16-byte aligned (the smoke
# config's 164 columns) and a dc that is no multiple of the 16-byte width
# (masked accesses).
CONV_SWEEP = [
    (16, 2048, 1792, 4, 3352, 1536, False, False),
    (1, 6720, 8448, 4, 16768, 8192, True, True),
    (3, 1000, 1792, 4, 3352, 1536, True, True),
    (2, 2, 256, 4, 256, 0, True, True),
    (2, 130, 96, 2, 164, 64, False, True),
    (1, 77, 40, 3, 40, 0, True, False),
    (2, 300, 100, 4, 164, 0, True, True),
]
# relative to the largest value: f32 sums in another order; bf16 the
# kernel rounds once against the plain version's rounding of the conv
CONV_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def ref_causal_conv(x, w, b=None, window=None):
    """silu(depthwise causal conv + b) as the Mamba-2 block computes it
    (``models/ssm.py``, the reference's stack of K shifted windows and
    einsum): x [B, S, dc], w [dc, K], b [dc] or None, window [B, K-1, dc]
    or None (zeros) -> [B, S, dc].  The conv is rounded to the operands'
    promoted dtype before the bias and the SiLU, as there."""
    B, S, dc = x.shape
    K = w.shape[-1]
    if window is None:
        window = torch.zeros((B, K - 1, dc), dtype=x.dtype, device=x.device)
    ci = torch.cat([window, x], dim=1)
    win = torch.stack([ci[:, i:i + S] for i in range(K)], dim=-1)  # [B,S,dc,K]
    dt = torch.promote_types(win.dtype, w.dtype)       # jnp.einsum's rule
    conv = torch.einsum("bsdk,dk->bsd", win.to(dt), w.to(dt))
    if b is not None:
        conv = conv + b
    return torch.nn.functional.silu(conv)


def ref_causal_conv_bwd(x, w, b, window, dy, *, want_window: bool = False):
    """The gradient kernel's arithmetic in plain torch, in f32 (or wider):
    the pre-activation recomputed from the inputs, g = dy * silu'(pre),
    dci[r] = sum_k g[r - k] * w[:, k] over ci = cat(window, x), dx =
    dci[K-1:], dw[:, k] = sum g * ci[k:k+S], db = sum g -> (dx, dw, db or
    None, dwindow or None) in x's, w's, b's and the window's dtypes."""
    B, S, dc = x.shape
    K = w.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    lead = (torch.zeros((B, K - 1, dc), dtype=acc, device=x.device)
            if window is None else window.to(acc))
    ci = torch.cat([lead, x.to(acc)], dim=1)                 # [B, S+K-1, dc]
    wf = w.to(acc)
    pre = sum(ci[:, k:k + S] * wf[:, k] for k in range(K))
    if b is not None:
        pre = pre + b.to(acc)
    sg = torch.sigmoid(pre)
    g = dy.to(acc) * (sg * (1 + pre * (1 - sg)))
    gp = torch.nn.functional.pad(g, (0, 0, K - 1, K - 1))    # [B, S+2K-2, dc]
    dci = sum(gp[:, K - 1 - k:K - 1 - k + S + K - 1] * wf[:, k]
              for k in range(K))                             # [B, S+K-1, dc]
    dw = torch.stack([(g * ci[:, k:k + S]).sum((0, 1)) for k in range(K)], -1)
    db = None if b is None else g.sum((0, 1)).to(b.dtype)
    dwin = dci[:, :K - 1].to(window.dtype) if want_window and \
        window is not None else None
    return dci[:, K - 1:].to(x.dtype), dw.to(w.dtype), db, dwin


# the SSD scan's plain versions, shapes and tolerances live in ref_ssd
from repro_torch.kernels.ref_ssd import (  # noqa: E402,F401
    SSD_SWEEP, SSD_TOL, ref_ssd, ref_ssd_bwd, ssd_chunk_parallel)
