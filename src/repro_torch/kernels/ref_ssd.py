"""Plain PyTorch versions of the SSD-scan kernels (``csrc/ssd_scan.cu``):
the sequential recurrence (:func:`ref_ssd`), the kernels' own chunked
decomposition (:func:`ssd_chunk_parallel`) and the scan's gradient in the
backward kernels' passes (:func:`ref_ssd_bwd`), each with an emulation of
the bf16 kernels' rounding points.  ``kernels.ref`` re-exports them
beside the other kernels' plain versions.
"""

from __future__ import annotations

import torch


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


def _split_bf16(t):
    """t as the bf16 kernels take an operand computed in f32: hi =
    bf16(t) plus lo = bf16(t − hi), about 16 significant bits."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def _chunked(t, S, Q, nc):
    """t [B, S, ...] in f32, zero-padded along S to nc chunks of Q."""
    return torch.nn.functional.pad(t.float(),
                                   (0, 0) * (t.dim() - 2) + (0, nc * Q - S))


def _decay(cs):
    """L [B, nc, H, Q, Q] = exp(cs_i − cs_j) on the lower triangle, for
    cs [B, nc, Q, H]; 0 above it, where the difference is positive and exp
    could overflow into 0·inf."""
    csh, Q = cs.permute(0, 1, 3, 2), cs.shape[2]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=cs.device).tril()
    return torch.exp(torch.where(tri, csh[..., :, None] - csh[..., None, :],
                                 float("-inf")))


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
    enter as they come, and each operand computed in f32 enters as bf16
    hi + lo (:func:`_split_bf16`): the decayed dt·x of the chunk state,
    h_in, and M' = (C·Bᵀ ∘ L)·dt_j, into which dt is folded so that the
    intra-chunk product takes x as it comes.  The state stays f32.
    Returns y in x's dtype (and the f32 state after the last token)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    f = lambda t: _chunked(t, S, Q, nc)  # noqa: E731
    rnd = _split_bf16 if round_bf16 else (lambda t: t)  # noqa: E731
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
    L = _decay(cs)                                        # [B,nc,H,Q,Q]
    M = rnd(cb[:, :, None] * L * dts.permute(0, 1, 3, 2)[..., None, :])
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xs)
    y_off = torch.einsum("bcin,bchpn->bcihp", cm, rnd(h_in))
    y = torch.exp(cs)[..., None] * y_off + y_diag
    y = y.reshape(Bb, nc * Q, H, P)[:, :S].to(x.dtype)
    return (y, h) if return_final else y


def ref_ssd_bwd(x, dt, A, Bm, Cm, dy, dh_final=None, *, chunk: int = 64,
                round_bf16: bool = False):
    """The SSD scan's gradient in the backward kernel's passes (the
    header of ``csrc/ssd_scan.cu`` derives them), in f32: ``dy`` [B,S,H,P]
    the cotangent of y, ``dh_final`` [B,H,P,N] that of the final state (or
    None) -> (dx, ddt, dA, dB, dC) in their inputs' dtypes.  Chunks of
    ``chunk`` tokens, zero-padded: the forward's passes give h_c, the state
    entering chunk c; (a') g_c = Σ_i exp(cs_i)·dy_i ⊗ C_i; (b') D_c, the
    gradient of the state leaving chunk c (D_last = dh_final or 0), D_{c−1}
    = exp(cs_last,c)·D_c + g_c; (c') du, dx = dt·du, dB and dC (summed over
    heads), and the decay's gradient reverse-summed into ddt and dA.
    ``round_bf16``: x, dy, B and C as they come, and as bf16 hi + lo
    (:func:`_split_bf16`) what the kernels take so — the chunk passes'
    decayed dt·x and exp(cs)·dy, and the gradient pass's h_c, D_c, M =
    C·Bᵀ ∘ L and T = L ∘ (dy·uᵀ); the states, D and the decay's sums
    (C·Bᵀ ∘ T, ⟨D_c, h_c⟩) stay f32."""
    (Bb, S, H, P), N = x.shape, Bm.shape[-1]
    Q, nc = chunk, -(-S // chunk)
    f = lambda t: _chunked(t, S, Q, nc)  # noqa: E731
    rnd = _split_bf16 if round_bf16 else (lambda t: t)  # noqa: E731
    xs, dys = (f(t).reshape(Bb, nc, Q, H, P) for t in (x, dy))
    bs, cm = (f(t).reshape(Bb, nc, Q, N) for t in (Bm, Cm))
    dts, Af = f(dt).reshape(Bb, nc, Q, H), A.float()
    cs = torch.cumsum(dts * Af, dim=2)                    # [B,nc,Q,H]
    last = cs[:, :, -1]                                   # [B,nc,H]
    e_in, e_out = torch.exp(cs), torch.exp(last[:, :, None] - cs)
    u = xs * dts[..., None]                               # [B,nc,Q,H,P]

    # the forward's chunk and state passes (h_c entering each chunk), then
    # (a') the chunk pass and (b') the reverse state pass (D_c)
    states = torch.einsum("bcqhp,bcqn->bchpn",
                          rnd(xs * (e_out * dts)[..., None]), bs)
    zero = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    h_in, _ = _carry(torch.exp(last), states, zero)
    g = torch.einsum("bcqhp,bcqn->bchpn", rnd(dys * e_in[..., None]), cm)
    Ds, _ = _carry(torch.exp(last), g, zero if dh_final is None
                   else dh_final.float(), reverse=True)

    # (c') gradient pass
    G = torch.einsum("bcin,bcjn->bcij", cm, bs)           # [B,nc,Q,Q]
    L = _decay(cs)                                        # [B,nc,H,Q,Q]
    hr, Dr = rnd(h_in), rnd(Ds)
    v = torch.einsum("bchpn,bcjn->bcjhp", Dr, bs)         # D_c·B_j
    w = torch.einsum("bchpn,bcin->bcihp", hr, cm)         # h_c·C_i
    du = (torch.einsum("bchij,bcihp->bcjhp", rnd(G[:, :, None] * L), dys)
          + e_out[..., None] * v)
    T = L * torch.einsum("bcihp,bcjhp->bchij", dys, u)    # L_ij (dy_i·u_j)
    R, Tr = G[:, :, None] * T, rnd(T)
    dC = (torch.einsum("bchij,bcjn->bcin", Tr, bs)
          + torch.einsum("bcihp,bchpn->bcin", dys * e_in[..., None], hr))
    dB = (torch.einsum("bchij,bcin->bcjn", Tr, cm)
          + torch.einsum("bcjhp,bchpn->bcjn", u * e_out[..., None], Dr))
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
