"""Mamba-2 (SSD: state-space duality, arXiv:2405.21060) block.

Chunked SSD algorithm: the sequence is split into chunks of length Q;
within a chunk the output is the quadratic (attention-like) form masked by
the cumulative decay; across chunks a recurrence carries the state
[H, P, N].  ``ssd_chunked`` launches the hand-written Hopper SSD-scan
kernel (``kernels.ops.ssd_scan``) on CUDA tensors, under autograd through
:class:`SSDScan`, whose backward launches the hand-written gradient
kernel (``kernels.ops.ssd_scan_bwd``: the gradient the reference's XLA
derives from its chunked math); on CPU tensors it runs
``ssd_chunked_plain``, the reference's chunked math line for line (the
kernel's plain version beside ``kernels.ref.ref_ssd``), and autograd
differentiates it, because a CPU tensor means the caller asked for the
CPU.  Any other device raises.

Decode: a single recurrent state update per token (``ssd_decode_step``),
O(H*P*N) per step, in plain torch ops, as the reference computes it
outside any kernel.

The block's depthwise causal conv with its bias and SiLU (``causal_conv``)
launches the hand-written conv kernel (``kernels.ops.causal_conv``) on
CUDA tensors of more than one row, under autograd through
:class:`CausalConv` (the gradient kernel ``kernels.ops.causal_conv_bwd``
backward); a one-row call (the decode step) runs the plain version
(``kernels.ref.ref_causal_conv``, the reference's stack and einsum), and
so do CPU and ``meta`` tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.ops import promoted
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ref_causal_conv
from repro_torch.models.layers import dense, rms_norm
from repro_torch.parallel.sharding import is_dtensor

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
    kernel (``kops.ssd_scan``) and saves only the inputs; the backward
    launches the gradient kernel (``kops.ssd_scan_bwd``, which recomputes
    the chunk states from the inputs) once, for the cotangents that
    arrived (``None`` ones are absent), and returns ``None`` for inputs
    that need no gradient.  That is the gradient XLA derives from the
    reference's chunked math (``src/repro/models/ssm.py:34``); the
    reference has no backward kernel.  On CPU tensors both wrappers run
    their plain versions (``ref_ssd``, ``ref_ssd_bwd``); on CUDA tensors
    a kernel that cannot build or launch raises.  Nothing here reads the
    device on the host, so a captured train step holds both passes."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, return_final):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.return_final = return_final
        ctx.set_materialize_grads(False)
        return kops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                             return_final=return_final)

    @staticmethod
    def backward(ctx, *grads):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        dy, dh = grads if ctx.return_final else (grads[0], None)
        if dy is None and dh is None:
            return (None,) * 7
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        gs = kops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dh)
        return tuple(g if need else None for g, need in
                     zip(gs, ctx.needs_input_grad)) + (None, None)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, return_final: bool = False,
                unroll: bool = False):
    """SSD forward (shapes as ``ssd_chunked_plain``).  CUDA tensors launch
    the SSD-scan kernel, through :class:`SSDScan` when autograd records
    (the kernel forward, the gradient kernel backward); CPU tensors run the
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


def _on_rows(fn, *args, replicated=()):
    """``fn(*args)`` on each card's batch rows (the SSD math is
    independent per row): DTensor arguments are laid out batch-sharded,
    1-d ones (``A``) and those at the positions in ``replicated`` (a
    weight) replicated, ``fn`` runs on the local shards, and its outputs
    are DTensors of the batch layout.  DTensor's own einsums mis-view some
    sharded operands.  Without DTensors, ``fn(*args)``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import as_dtensor, logical
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if not any(isinstance(t, DTensor) for t in ts):
        return fn(*args)
    mesh = next(t.device_mesh for t in ts if isinstance(t, DTensor))
    pl, local = None, []
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor):
            rows = a.ndim > 1 and i not in replicated
            a = logical(as_dtensor(a, mesh), *(
                ["batch"] + [None] * (a.ndim - 1) if rows
                else [None] * a.ndim))
            if rows and pl is None:
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

class CausalConv(torch.autograd.Function):
    """The conv as autograd sees it: the forward launches the conv kernel
    (``kops.causal_conv``) and saves only its inputs; the backward launches
    the gradient kernel (``kops.causal_conv_bwd``, which recomputes the
    pre-activation) once, and asks it for the window's gradient only when
    autograd wants it.  Nothing here reads the device on the host, so a
    captured train step holds both passes."""

    @staticmethod
    def forward(ctx, x, w, b, window):
        ctx.save_for_backward(x, w, b, window)
        ctx.set_materialize_grads(False)
        return kops.causal_conv(x, w, b, window)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return (None,) * 4
        x, w, b, window = ctx.saved_tensors
        if dy.shape[-1] > 1 and dy.stride(-1) != 1:
            dy = dy.contiguous()
        need = ctx.needs_input_grad
        gs = kops.causal_conv_bwd(x, w, b, window, dy, want_window=need[3])
        return tuple(g if n else None for g, n in zip(gs, need))


def causal_conv(x, w, b=None, window=None):
    """silu(depthwise causal conv of x [B, S, dc] after ``window`` [B, K-1,
    dc] (zeros when None) with taps w [dc, K], plus b [dc]).  The path
    follows what the call shows: one row (S == 1, the decode step) runs
    the plain version; a CUDA tensor launches the conv kernel, through
    :class:`CausalConv` when autograd records; CPU and ``meta`` tensors run
    the plain version through the wrapper."""
    if x.shape[1] == 1:
        return ref_causal_conv(x, w, b, window)
    if x.device.type == "cuda" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b, window)):
        return CausalConv.apply(x, w, b, window)
    return kops.causal_conv(x, w, b, window)


def _mix(zxbcdt, dt_bias, w_conv, conv_state, sizes, b_conv=None,
         lengths=None):
    """Between mamba2_block's projections: the split into (z gate, x, B,
    C, dt heads), dt = softplus(dt + dt_bias) and the depthwise causal
    conv over (x, B, C) as in Mamba-2 (plus ``b_conv`` when given), after
    the window ``conv_state`` [B, K-1, dc] (zeros when None).  Returns
    (z, dt, silu(conv), the new window: the last K-1 rows, or None without
    a state).  ``lengths`` [B] (a padded prefill): row b's window is its
    last K-1 real rows, and its dt is 0 from position ``lengths[b]`` on,
    so the scan's decay there is 1 and its update 0.  The conv reads (x,
    B, C) where they lie, adjacent columns of ``zxbcdt``."""
    d_inner, H = sizes[0], sizes[-1]
    z, conv_in, dt = torch.split(
        zxbcdt, [d_inner, zxbcdt.shape[-1] - d_inner - H, H], dim=-1)
    dt = F.softplus(dt + dt_bias)                                # [B,S,H]
    B, S, dc = conv_in.shape
    K = w_conv.shape[-1]
    new_conv_state = None
    if conv_state is not None:
        ci = torch.cat([conv_state, conv_in], dim=1)
        if lengths is None:
            new_conv_state = ci[:, -(K - 1):]
        else:
            # real token t sits at row t + K - 1 of ci
            rows = lengths.long()[:, None] + torch.arange(
                K - 1, device=ci.device)
            new_conv_state = torch.gather(
                ci, 1, rows[..., None].expand(-1, -1, dc))
    if lengths is not None:
        real = torch.arange(S, device=dt.device) < lengths.long()[:, None]
        dt = dt * real[..., None].to(dt.dtype)
    conv_out = causal_conv(conv_in, w_conv, b_conv, conv_state)
    return z, dt, conv_out, new_conv_state


def mamba2_block(p, x, cfg, *, cache=None, lengths=None):
    """x: [B, S, d].  cache: None or dict(conv [B,K-1,dc], ssm [B,H,P,N]).

    Projections follow Mamba-2: in_proj -> (z gate, x, B, C, dt heads).
    A prefill with a cache starts from a zero state, as the reference's
    does; its conv reads the cache's conv window.  ``lengths`` [B] (a
    prefill padded past each row's length): the new state and conv window
    are those at each row's last real token (:func:`_mix`).  The config's
    ``conv_bias`` (``b_conv``), ``ssm_d_skip`` (``y += x * d_skip``, per
    head) and ``ssm_gated_norm`` (``rmsnorm(y * silu(z))`` in float32,
    scale ``norm.scale``, in place of ``y * silu(z)``) are Mamba-2's
    layer options.
    """
    B, S, d = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner = H * P

    zxbcdt = dense(x, p["w_in"])            # [B,S, 2*d_inner + 2*N + H]
    sizes = [d_inner, d_inner, N, N, H]
    b_conv = p["b_conv"] if cfg.conv_bias else None
    if cache is not None and is_dtensor(cache["conv"]):
        # a cache under a mesh: its conv window is sharded over the model
        # axis on its width, and DTensor's cat, stack and einsum over that
        # layout fail on some torch versions
        z, dt, conv_out, new_conv_state = _on_rows(
            _mix, zxbcdt, p["dt_bias"], p["w_conv"], cache["conv"], sizes,
            b_conv, lengths, replicated=(2,))
    else:
        z, dt, conv_out, new_conv_state = _mix(
            zxbcdt, p["dt_bias"], p["w_conv"],
            None if cache is None else cache["conv"], sizes, b_conv,
            lengths)
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

    if cfg.ssm_d_skip:
        y = (y.float() + xc.float() * p["d_skip"].float()[:, None]
             ).to(y.dtype)
    y = y.reshape(B, S, d_inner)
    if cfg.ssm_gated_norm:
        y = rms_norm(y.float() * F.silu(z.float()), p["norm"]["scale"],
                     cfg.norm_eps).to(y.dtype)
    else:
        y = y * F.silu(z)
    out = dense(y, p["w_out"])
    if cache is not None:
        return out, {"conv": new_conv_state, "ssm": new_ssm_state}
    return out, None
