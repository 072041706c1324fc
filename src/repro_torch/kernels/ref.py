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


# The shapes and tolerances at which the SSD-scan kernels are held against
# ref_ssd and the chunked math (tests and chip_smoke.py): the reference's
# tests/test_kernels.py:48-54, a prime length (the reference's chunk
# halves to 1) and a length below the chunk; then cases for the
# chunk-parallel kernels (chunk Q = 64): S = 1, S = Q + 1 and 2Q + 1,
# three or more chunks with N = 128 at P = 64 (mamba2-130m's state), N not
# a multiple of 8 (element-wise staging, zero-padded k) with an odd head
# count, and P = 128 (two column blocks) on a ragged length.  Every case
# is fast enough for the reference's Pallas kernel in interpret mode.
SSD_SWEEP = [
    # (B, S, H, P, N, chunk)
    (1, 64, 2, 16, 16, 16),
    (2, 128, 4, 32, 32, 32),
    (1, 128, 2, 64, 16, 64),
    (1, 96, 2, 16, 32, 32),
    (1, 37, 2, 16, 16, 16),
    (2, 20, 2, 16, 16, 64),
    (1, 1, 2, 16, 16, 16),
    (1, 65, 2, 16, 32, 64),
    (1, 129, 2, 16, 16, 128),
    (1, 384, 2, 64, 128, 128),
    (2, 192, 3, 32, 24, 64),
    (1, 130, 3, 128, 36, 64),
]
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _carry(decay, add, h, reverse=False):
    """The recurrence over chunks h <- decay_c·h + add_c (decay [B, nc,
    H], add [B, nc, H, P, N]), from h before the first chunk (the last
    with ``reverse``): (each chunk's h before its update, stacked [B, nc,
    H, P, N]; h after the last update)."""
    before = [None] * add.shape[1]
    for c in (reversed(range(len(before))) if reverse else
              range(len(before))):
        before[c] = h
        h = decay[:, c, :, None, None] * h + add[:, c]
    return torch.stack(before, 1), h


def ssd_chunk_parallel(x, dt, A, Bm, Cm, *, chunk: int = 64,
                       round_bf16: bool = False, return_final: bool = False):
    """The SSD-scan kernels' decomposition in plain torch (shapes as
    :func:`ref_ssd`): the sequence zero-padded to chunks of ``chunk``
    tokens (dt = 0 past S keeps the decay exact), then

    - chunk pass: cs = the in-chunk inclusive cumsum of dt·A, each chunk's
      state s_c = Σ_j exp(cs_last − cs_j)·dt_j·x_jᵀ·B_j and decay
      exp(cs_last);
    - state pass: h_in(0) = 0, h_in(c+1) = exp(cs_last,c)·h_in(c) + s_c;
    - output pass: y = exp(cs_i)·C_i·h_in(c)ᵀ + (C·Bᵀ ∘ L)·(dt·x), with
      L_ij = exp(cs_i − cs_j) taken on the lower triangle only.

    Products are f32 sums of exact products, as on the tensor cores.
    ``round_bf16`` applies the bf16 kernels' operand rounding: B, C and x
    enter as they come, and each operand computed in f32 enters as two
    bf16 terms, hi = bf16(v) and lo = bf16(v − hi): the decayed dt·x of
    the chunk state, h_in, and M' = (C·Bᵀ ∘ L)·dt_j, into which dt is
    folded so that the intra-chunk product takes x as it comes.  The state
    stays f32.  Returns y in x's dtype (and the f32 state after the last
    token)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    f = lambda t: torch.nn.functional.pad(   # noqa: E731
        t.float(), (0, 0) * (t.dim() - 2) + (0, pad))

    def rnd(t):                                           # hi + lo in bf16
        if not round_bf16:
            return t
        hi = t.to(torch.bfloat16).float()
        return hi + (t - hi).to(torch.bfloat16).float()

    xs = f(x).reshape(Bb, nc, Q, H, P)
    dts = f(dt).reshape(Bb, nc, Q, H)
    bs = f(Bm).reshape(Bb, nc, Q, N)
    cm = f(Cm).reshape(Bb, nc, Q, N)
    cs = torch.cumsum(dts * A.float(), dim=2)             # [B,nc,Q,H]
    last = cs[:, :, -1:]                                  # [B,nc,1,H]

    # (a) chunk pass
    w = torch.exp(last - cs) * dts                        # [B,nc,Q,H]
    xw = rnd(xs * w[..., None])
    states = torch.einsum("bcqhp,bcqn->bchpn", xw, bs)    # [B,nc,H,P,N]
    decay = torch.exp(last[:, :, 0])                      # [B,nc,H]

    # (b) state pass
    h_in, h = _carry(decay, states, torch.zeros(
        (Bb, H, P, N), dtype=torch.float32, device=x.device))

    # (c) output pass
    cb = torch.einsum("bcin,bcjn->bcij", cm, bs)          # [B,nc,Q,Q]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = cs.permute(0, 1, 3, 2)[..., :, None] - cs.permute(0, 1, 3, 2)[
        ..., None, :]                                     # [B,nc,H,Q,Q]
    L = torch.exp(torch.where(tri, diff, float("-inf")))
    M = rnd(cb[:, :, None] * L * dts.permute(0, 1, 3, 2)[..., None, :])
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xs)
    y_off = torch.einsum("bcin,bchpn->bcihp", cm, rnd(h_in))
    y = torch.exp(cs)[..., None] * y_off + y_diag
    y = y.reshape(Bb, nc * Q, H, P)[:, :S].to(x.dtype)
    return (y, h) if return_final else y


def ref_ssd_bwd(x, dt, A, Bm, Cm, dy, dh_final=None, *, chunk: int = 64):
    """The SSD scan's gradient in the backward kernel's passes (the
    header of ``csrc/ssd_scan.cu`` derives them), in f32: ``dy`` [B,S,H,P]
    the cotangent of y, ``dh_final`` [B,H,P,N] that of the final state (or
    None) -> (dx, ddt, dA, dB, dC) in their inputs' dtypes.  Chunks of
    ``chunk`` tokens, zero-padded: the forward's passes give h_c, the state
    entering chunk c; (a') g_c = Σ_i exp(cs_i)·dy_i ⊗ C_i; (b') D_c, the
    gradient of the state leaving chunk c (D_last = dh_final or 0), D_{c−1}
    = exp(cs_last,c)·D_c + g_c; (c') du, dx = dt·du, dB and dC (summed over
    heads), and the decay's gradient reverse-summed into ddt and dA."""
    (Bb, S, H, P), N = x.shape, Bm.shape[-1]
    Q, nc = chunk, -(-S // chunk)
    f = lambda t: torch.nn.functional.pad(   # noqa: E731
        t.float(), (0, 0) * (t.dim() - 2) + (0, nc * Q - S))
    xs, dys = (f(t).reshape(Bb, nc, Q, H, P) for t in (x, dy))
    bs, cm = (f(t).reshape(Bb, nc, Q, N) for t in (Bm, Cm))
    dts, Af = f(dt).reshape(Bb, nc, Q, H), A.float()
    cs = torch.cumsum(dts * Af, dim=2)                    # [B,nc,Q,H]
    last = cs[:, :, -1]                                   # [B,nc,H]
    e_in, e_out = torch.exp(cs), torch.exp(last[:, :, None] - cs)
    u = xs * dts[..., None]                               # [B,nc,Q,H,P]

    # the forward's chunk and state passes (h_c entering each chunk), then
    # (a') the chunk pass and (b') the reverse state pass (D_c)
    states = torch.einsum("bcqhp,bcqn->bchpn", u * e_out[..., None], bs)
    zero = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    h_in, _ = _carry(torch.exp(last), states, zero)
    g = torch.einsum("bcqhp,bcqn->bchpn", dys * e_in[..., None], cm)
    Ds, _ = _carry(torch.exp(last), g, zero if dh_final is None
                   else dh_final.float(), reverse=True)

    # (c') gradient pass
    G = torch.einsum("bcin,bcjn->bcij", cm, bs)           # [B,nc,Q,Q]
    csh = cs.permute(0, 1, 3, 2)                          # [B,nc,H,Q]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, csh[..., :, None] - csh[..., None, :],
                              float("-inf")))             # [B,nc,H,Q,Q]
    v = torch.einsum("bchpn,bcjn->bcjhp", Ds, bs)         # D_c·B_j
    w = torch.einsum("bchpn,bcin->bcihp", h_in, cm)       # h_c·C_i
    du = (torch.einsum("bcij,bchij,bcihp->bcjhp", G, L, dys)
          + e_out[..., None] * v)
    T = L * torch.einsum("bcihp,bcjhp->bchij", dys, u)    # L_ij (dy_i·u_j)
    R = G[:, :, None] * T
    dC = (torch.einsum("bchij,bcjn->bcin", T, bs)
          + torch.einsum("bcihp,bchpn->bcin", dys * e_in[..., None], h_in))
    dB = (torch.einsum("bchij,bcin->bcjn", T, cm)
          + torch.einsum("bcjhp,bchpn->bcjn", u * e_out[..., None], Ds))
    uv = (u * v).sum(-1)                                  # [B,nc,Q,H]
    dcs = (R.sum(-1) - R.sum(-2)).permute(0, 1, 3, 2) \
        + e_in * (dys * w).sum(-1) - e_out * uv           # [B,nc,Q,H]
    dcs[:, :, -1] += (e_out * uv).sum(2) \
        + torch.exp(last) * (Ds * h_in).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2])
    ddt = (xs * du).sum(-1) + Af * da
    dA = (dts * da).sum((0, 1, 2))
    out = lambda t, like: t.reshape(  # noqa: E731
        (Bb, nc * Q) + tuple(t.shape[3:]))[:, :S].to(like.dtype)
    return (out(du * dts[..., None], x), out(ddt, dt), dA.to(A.dtype),
            out(dB, Bm), out(dC, Cm))


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
