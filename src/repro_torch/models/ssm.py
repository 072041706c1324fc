"""Mamba-2 (SSD: state-space duality, arXiv:2405.21060) block.

Chunked SSD algorithm: the sequence is split into chunks of length Q;
within a chunk the output is the quadratic (attention-like) form masked by
the cumulative decay; across chunks a recurrence carries the state
[H, P, N].  ``ssd_chunked`` launches the hand-written Hopper SSD-scan
kernel (``kernels.ops.ssd_scan``) on CUDA tensors, under autograd through
:class:`SSDScan` (the kernel forward; the backward differentiates the
plain chunked math, as the reference's XLA does); on CPU tensors it runs
``ssd_chunked_plain``, the reference's chunked math line for line (the
kernel's plain version beside ``kernels.ref.ref_ssd``), because a CPU
tensor means the caller asked for the CPU.  Any other device raises.

Decode: a single recurrent state update per token (``ssd_decode_step``),
O(H*P*N) per step, in plain torch ops, as the reference computes it
outside any kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.ops import promoted
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense

# torch.einsum with jnp's promotion (torch refuses mixed dtypes)
_promoted_einsum = promoted(lambda *xs, expr: torch.einsum(expr, *xs))


def _einsum(expr, *operands):
    return _promoted_einsum(*operands, expr=expr)


def _segsum(a_chunk):
    """log-space cumulative decay matrix L[i, j] = sum_{k=j+1..i} a_k for
    i >= j else -inf.  a_chunk: [..., Q]."""
    Q = a_chunk.shape[-1]
    cs = torch.cumsum(a_chunk, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]       # [.., i, j] = cs_i - cs_j
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=a_chunk.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked_plain(x, dt, A, Bm, Cm, chunk: int,
                      return_final: bool = False):
    """The reference's chunked SSD forward on any device, with its dtype
    flow (bf16 x bf16 scores, f32 decay and state, y cast to x's dtype).

    x:  [B, S, H, P]   (inputs per head)
    dt: [B, S, H]      (positive step sizes, post-softplus)
    A:  [H]            (negative decay rates)
    Bm: [B, S, N]      (input projection, shared across heads — Mamba-2)
    Cm: [B, S, N]      (output projection)
    returns y: [B, S, H, P] (and the final state [B, H, P, N] f32)
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    nc = S // Q

    a = dt * A[None, None, :]                        # [B,S,H] log-decay (<0)
    xr = x.reshape(B, nc, Q, H, P)
    ar = a.reshape(B, nc, Q, H)
    dtr = dt.reshape(B, nc, Q, H)
    Br = Bm.reshape(B, nc, Q, N)
    Cr = Cm.reshape(B, nc, Q, N)

    # ---- intra-chunk (quadratic, attention-like) --------------------------
    L = torch.exp(_segsum(ar.permute(0, 1, 3, 2)))   # [B,nc,H,Q,Q]
    scores = _einsum("bcqn,bckn->bcqk", Cr, Br)      # [B,nc,Q,Q]
    M = scores[:, :, None] * L                       # [B,nc,H,Q,Q]
    y_diag = _einsum("bchqk,bckh,bckhp->bcqhp", M, dtr, xr)

    # ---- chunk states ------------------------------------------------------
    a_cum = torch.cumsum(ar, dim=2)                  # [B,nc,Q,H]
    a_tot = a_cum[:, :, -1]                          # [B,nc,H]
    decay_states = torch.exp(a_tot[:, :, None] - a_cum)        # [B,nc,Q,H]
    states = _einsum("bcqn,bcqh,bcqh,bcqhp->bchpn",
                     Br, decay_states, dtr, xr)      # [B,nc,H,P,N]

    # ---- inter-chunk recurrence (the reference's lax.scan) ----------------
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    st, atot = states.float(), a_tot.float()
    prev = []
    for c in range(nc):
        prev.append(h)                               # state BEFORE chunk c
        h = h * torch.exp(atot[:, c])[:, :, None, None] + st[:, c]
    h_final, prev_states = h, torch.stack(prev, 1)   # [B,nc,H,P,N]

    # ---- contribution of carried state to each position --------------------
    state_decay = torch.exp(a_cum)                   # [B,nc,Q,H]
    y_off = _einsum("bcqn,bchpn,bcqh->bcqhp", Cr.float(), prev_states,
                    state_decay.float())

    y = (y_diag.float() + y_off).reshape(B, S, H, P)
    y = y.to(x.dtype)
    if return_final:
        return y, h_final
    return y


class SSDScan(torch.autograd.Function):
    """The SSD scan as autograd sees it: the forward launches the SSD-scan
    kernel (``kops.ssd_scan``; its plain version on CPU tensors) and saves
    only the inputs; the backward recomputes :func:`ssd_chunked_plain`
    under ``enable_grad`` and returns its gradients.  That is the
    reference's own gradient: XLA differentiates the plain chunked math,
    and neither package has a backward kernel.  Nothing here reads the
    device on the host, so a captured train step holds both passes."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, return_final):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk, ctx.return_final = chunk, return_final
        ctx.set_materialize_grads(False)
        return kops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                             return_final=return_final)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(t.requires_grad)
                  for t in inputs]
            out = ssd_chunked_plain(*xs, ctx.chunk, ctx.return_final)
            outs = out if ctx.return_final else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wrt = [x for x in xs if x.requires_grad]
            gs = iter(torch.autograd.grad([o for o, _ in pairs],
                                          wrt, [g for _, g in pairs],
                                          allow_unused=True))
        return tuple(next(gs) if x.requires_grad else None
                     for x in xs) + (None, None)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, return_final: bool = False,
                unroll: bool = False):
    """SSD forward (shapes as ``ssd_chunked_plain``).  CUDA tensors launch
    the SSD-scan kernel, through :class:`SSDScan` when autograd records
    (the kernel forward, the plain math's gradients); CPU tensors run the
    plain chunked math, and so do ``meta`` tensors (the dry run's shape
    propagation: nothing is computed); any other device raises.
    ``unroll`` (the reference's dry-run switch) is kept only so that the
    reference's calls carry over; it has no effect."""
    del unroll
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, A, Bm, Cm)):
            return SSDScan.apply(x, dt, A, Bm, Cm, chunk, return_final)
        return kops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                             return_final=return_final)
    if x.device.type == "meta":
        return _on_rows(ssd_chunked_plain, x, dt, A, Bm, Cm, chunk,
                        return_final)
    if x.device.type != "cpu":
        raise NotImplementedError(f"no SSD kernel for {x.device}")
    return ssd_chunked_plain(x, dt, A, Bm, Cm, chunk, return_final)


def _on_rows(fn, *args):
    """``fn(*args)`` on each card's batch rows (the SSD math is
    independent per row): DTensor arguments are laid out batch-sharded,
    1-d ones (``A``) replicated, ``fn`` runs on the local shards, and its
    outputs are DTensors of the batch layout.  DTensor's own einsums
    mis-view some sharded operands.  Without DTensors, ``fn(*args)``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import as_dtensor, logical
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if not any(isinstance(t, DTensor) for t in ts):
        return fn(*args)
    mesh = next(t.device_mesh for t in ts if isinstance(t, DTensor))
    pl, local = None, []
    for a in args:
        if isinstance(a, torch.Tensor):
            a = logical(as_dtensor(a, mesh), *(
                [None] if a.ndim == 1 else ["batch"] + [None] * (a.ndim - 1)))
            if a.ndim > 1 and pl is None:
                pl = a.placements
            a = a.to_local()
        local.append(a)
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                    for o in outs)
    return wrapped if isinstance(out, tuple) else wrapped[0]


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token recurrent update.

    state: [B, H, P, N]; x: [B, H, P]; dt: [B, H]; Bm/Cm: [B, N]
    returns (y [B,H,P], new_state).  ``meta`` tensors (the dry run) run
    it on each card's rows.
    """
    if x.device.type == "meta":
        return _on_rows(_ssd_decode_math, state, x, dt, A, Bm, Cm)
    return _ssd_decode_math(state, x, dt, A, Bm, Cm)


def _ssd_decode_math(state, x, dt, A, Bm, Cm):
    da = torch.exp(dt * A[None, :]).float()                    # [B,H]
    upd = _einsum("bn,bh,bhp->bhpn", Bm, dt, x).float()
    new_state = state.float() * da[:, :, None, None] + upd
    y = _einsum("bn,bhpn->bhp", Cm.float(), new_state)
    return y.to(x.dtype), new_state


# --------------------------------------------------------------------------
# Full Mamba-2 block (projections + conv + SSD + gate)
# --------------------------------------------------------------------------

def mamba2_block(p, x, cfg, *, cache=None):
    """x: [B, S, d].  cache: None or dict(conv [B,K-1,dc], ssm [B,H,P,N]).

    Projections follow Mamba-2: in_proj -> (z gate, x, B, C, dt heads).
    A prefill with a cache starts from a zero state, as the reference's
    does; its conv reads the cache's conv window.
    """
    B, S, d = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner = H * P
    K = cfg.conv_kernel

    zxbcdt = dense(x, p["w_in"])            # [B,S, 2*d_inner + 2*N + H]
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, H],
                                     dim=-1)
    dt = F.softplus(dt + p["dt_bias"])               # [B,S,H]

    # depthwise causal conv over (x, B, C) as in Mamba-2
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                   # [B,S,dc]
    dc = conv_in.shape[-1]
    new_conv_state = None
    if cache is None:
        pad = torch.zeros((B, K - 1, dc), dtype=conv_in.dtype,
                          device=x.device)
        ci = torch.cat([pad, conv_in], dim=1)
    else:
        ci = torch.cat([cache["conv"], conv_in], dim=1)
        new_conv_state = ci[:, -(K - 1):]
    win = torch.stack([ci[:, i:i + S] for i in range(K)], dim=-1)  # [B,S,dc,K]
    conv_out = F.silu(_einsum("bsdk,dk->bsd", win, p["w_conv"]))
    xc, Bc, Cc = torch.split(conv_out, [d_inner, N, N], dim=-1)
    xc = xc.reshape(B, S, H, P)

    A = -torch.exp(p["a_log"])                       # [H], negative
    new_ssm_state = None
    if cache is None:
        y = ssd_chunked(xc, dt, A, Bc, Cc, cfg.ssd_chunk, unroll=cfg.unroll)
    elif S > 1:
        # prefill-with-cache: also return the final recurrent state
        y, new_ssm_state = ssd_chunked(xc, dt, A, Bc, Cc, cfg.ssd_chunk,
                                       return_final=True, unroll=cfg.unroll)
    else:
        y1, new_ssm_state = ssd_decode_step(
            cache["ssm"], xc[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0])
        y = y1[:, None]

    y = y.reshape(B, S, d_inner)
    y = y * F.silu(z)
    out = dense(y, p["w_out"])
    if cache is not None:
        return out, {"conv": new_conv_state, "ssm": new_ssm_state}
    return out, None
