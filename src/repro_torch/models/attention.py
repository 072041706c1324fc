"""Attention: GQA / MQA, causal, sliding-window, local and cross, with
dense and paged KV caches.  ``chunked_attention`` is the blockwise
online-softmax path (peak memory O(Bq*Bk) instead of O(S^2)); paged
single-token decode goes through the hand-written paged-attention kernel
when the kernel-substituted decode op enables it (:func:`paged_kernel`).

Caches are written in place only under :func:`cache_in_place`, which the
pool ops' in-place forms set when their caller owns the cache (a steady
iteration's donated pool, serve/scheduler/inplace.py); otherwise the
engine may hold the iteration-start buffers for rollback, so each update
makes a new tensor.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.models.layers import dense, rope
from repro_torch.parallel.sharding import constrain

NEG_INF = -1e30

# Switch read while the decode op runs: when set, paged-cache decode
# attends through the paged-attention kernel instead of the gather + dense
# path.  Set by the kernel-substituted ``kernel.slot_decode_paged`` op
# around its execution (pass pipeline ``kernels``, DESIGN.md §12).  It is
# per thread: the GraphRunner thread and the Python thread run ops
# concurrently.
_FLAGS = threading.local()


def paged_kernel_enabled() -> bool:
    return getattr(_FLAGS, "paged_kernel", False)


@contextlib.contextmanager
def paged_kernel():
    prev = paged_kernel_enabled()
    _FLAGS.paged_kernel = True
    try:
        yield
    finally:
        _FLAGS.paged_kernel = prev


def cache_in_place_enabled() -> bool:
    return getattr(_FLAGS, "in_place", False)


@contextlib.contextmanager
def cache_in_place():
    """Write the new K/V into the cache tensors the step was given (the
    pool ops' in-place forms), instead of into fresh copies."""
    prev = cache_in_place_enabled()
    _FLAGS.in_place = True
    try:
        yield
    finally:
        _FLAGS.in_place = prev


def _pick_block(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (block sizes must tile s)."""
    b = min(target, s)
    while s % b:
        b -= 1
    return max(b, 1)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_block: int = 512, kv_block: int = 1024,
                      q_offset: int = 0, kv_valid_len=None):
    """q: [B,Sq,Hq,D], k/v: [B,Skv,Hkv,D] with Hq % Hkv == 0.

    ``window`` > 0 restricts attention to the last ``window`` keys (SWA /
    local attention).  ``q_offset`` is the absolute position of q[0];
    ``kv_valid_len`` masks keys at or past it.  Scores and the accumulator
    are f32; the result is cast back to q's dtype.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5
    dev = q.device

    qb = _pick_block(Sq, q_block)
    kb = _pick_block(Skv, kv_block)
    nq, nk = Sq // qb, Skv // kb

    # [B, Hkv, G, nq, qb, D]
    qr = q.reshape(B, nq, qb, Hkv, G, D).permute(0, 3, 4, 1, 2, 5) * scale
    kr = k.reshape(B, nk, kb, Hkv, D).permute(0, 3, 1, 2, 4)
    vr = v.reshape(B, nk, kb, Hkv, D).permute(0, 3, 1, 2, 4)

    q_pos = q_offset + torch.arange(Sq, device=dev).reshape(nq, qb)
    k_pos = torch.arange(Skv, device=dev).reshape(nk, kb)

    outs = []
    for qi in range(nq):
        qblk = qr[:, :, :, qi].float()              # [B,Hkv,G,qb,D]
        qp = q_pos[qi]
        acc = torch.zeros((B, Hkv, G, qb, D), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, Hkv, G, qb), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, qb), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kblk = kr[:, :, ki]                     # [B,Hkv,kb,D]
            vblk = vr[:, :, ki]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kblk.float())
            kp = k_pos[ki]
            mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
            if causal:
                mask &= qp[:, None] >= kp[None, :]
            if window:
                mask &= kp[None, :] > qp[:, None] - window
            if kv_valid_len is not None:
                mask &= kp[None, :] < kv_valid_len
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.to(q.dtype))
    # [nq, B, Hkv, G, qb, D] -> [B, Sq, Hq, D]
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, Hq, D)
    return out


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-token decode: q [B,1,Hq,D]; caches [B,Smax,Hkv,D];
    cache_len: [B] tensor or int valid length."""
    B, _, Hq, D = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, D) * (D ** -0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qr.float(), k_cache.float())
    pos = torch.arange(Smax, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < cl
    if window:
        valid &= pos[None, :] >= cl - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# --------------------------------------------------------------------------
# Full attention block (projections + rope + cache handling)
# --------------------------------------------------------------------------

def attention_block(p, x, cfg, *, positions=None, cache=None,
                    cross_states=None, causal=True, window=0,
                    use_rope=True):
    """Returns (out, new_cache).

    cache: None (prefill-no-cache) or dict with k/v [B,Smax,Hkv,D] and
    ``len`` (filled length: an int for lock-step batches, a [B] tensor for
    slot-pooled serving), or the paged form kp/vp + block table ``bt``.
    When ``cross_states`` [B, Skv, d] is given, k/v come from those
    encoder / vision states: no rope, no cache read or write, no causal
    mask (the reference re-projects them at every decode step).
    ``cfg.nope``: no rotary positions; ``cfg.attn_scale`` (when set and
    not D^-1/2): the softmax scale, folded into q.
    """
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = dense(x, p["wq"], p.get("bq")).reshape(B, S, H, D)
    kv_src = cross_states if cross_states is not None else x
    Skv = kv_src.shape[1]
    k = dense(kv_src, p["wk"], p.get("bk")).reshape(B, Skv, Hkv, D)
    v = dense(kv_src, p["wv"], p.get("bv")).reshape(B, Skv, Hkv, D)

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.attn_scale and cfg.attn_scale != D ** -0.5:
        # every path below scales scores by D^-1/2: fold the ratio into q
        q = q * (cfg.attn_scale * D ** 0.5)
    if use_rope and not cfg.nope and cross_states is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, torch.arange(Skv, device=x.device)[None, :]
                 if cache is None else positions, cfg.rope_theta)

    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)

    new_cache = None
    if cross_states is not None:
        cache = None                    # cross K/V are never cached
    if cache is not None and "kp" in cache:
        # paged decode: K/V live in a flat block arena addressed through
        # the per-slot block table ``bt`` [B, nbps].  The new K/V lands at
        # the row's current position (block-table indirection); attention
        # gathers the row's blocks back into logical order, which is
        # bit-identical to the dense row, so paged == dense greedy tokens.
        idx = cache["len"]
        if S != 1 or not isinstance(idx, torch.Tensor) or idx.dim() != 1:
            raise NotImplementedError(
                "paged cache supports vector-position single-token decode")
        kp, vp, bt = cache["kp"], cache["vp"], cache["bt"]
        kv = k.to(kp.dtype)[:, 0]                  # [B, Hkv, D]
        vv = v.to(vp.dtype)[:, 0]
        nblk, bs = kp.shape[0], kp.shape[1]
        # positions stay below max_len = nbps * bs (the scheduler's submit
        # check); the clamp only keeps an index inside the table
        col = torch.clamp_max(idx.long() // bs, bt.shape[1] - 1)
        blk = torch.gather(bt.long(), 1, col[:, None])[:, 0]
        dest = blk * bs + idx.long() % bs          # flat arena position
        if cache_in_place_enabled():
            kp.view(nblk * bs, Hkv, D).index_copy_(0, dest, kv)
            vp.view(nblk * bs, Hkv, D).index_copy_(0, dest, vv)
        else:
            kp = kp.reshape(nblk * bs, Hkv, D).index_copy(0, dest, kv) \
                .reshape(kp.shape)
            vp = vp.reshape(nblk * bs, Hkv, D).index_copy(0, dest, vv) \
                .reshape(vp.shape)
        new_cache = {"kp": kp, "len": idx + 1, "vp": vp}
        if paged_kernel_enabled():
            from repro_torch.kernels import ops as kops
            out = kops.paged_attention(q, kp, vp, bt, idx + 1,
                                       window=window)
        else:
            Bq, nbps = bt.shape
            kg = kp[bt.long()].reshape(Bq, nbps * bs, Hkv, D)
            vg = vp[bt.long()].reshape(Bq, nbps * bs, Hkv, D)
            out = decode_attention(q, kg, vg, idx + 1, window=window)
    elif cache is not None:
        # decode/step mode: append to cache then attend over it.  ``len``
        # is an int (lock-step: every row at the same fill) or a [B]
        # tensor (slot-pooled serving: per-slot positions) — the vector
        # case writes each row at its own offset.
        idx = cache["len"]
        k_cache, v_cache = cache["k"], cache["v"]
        kv, vv = k.to(k_cache.dtype), v.to(v_cache.dtype)
        own = cache_in_place_enabled()
        if isinstance(idx, torch.Tensor):
            if S != 1:
                raise NotImplementedError(
                    "per-row cache positions support single-token decode "
                    "only (got S=%d)" % S)
            rows = torch.arange(B, device=x.device)
            col = idx.long()
            if own:
                k_cache.index_put_((rows, col), kv[:, 0])
                v_cache.index_put_((rows, col), vv[:, 0])
            else:
                k_cache = k_cache.index_put((rows, col), kv[:, 0])
                v_cache = v_cache.index_put((rows, col), vv[:, 0])
        elif own:
            k_cache[:, idx:idx + S] = kv
            v_cache[:, idx:idx + S] = vv
        else:
            k_cache = k_cache.slice_scatter(kv, 1, idx, idx + S)
            v_cache = v_cache.slice_scatter(vv, 1, idx, idx + S)
        new_cache = {"k": k_cache, "v": v_cache, "len": idx + S}
        if S == 1:
            out = decode_attention(q, k_cache, v_cache, idx + 1,
                                   window=window)
        else:
            out = chunked_attention(q, k_cache, v_cache, causal=causal,
                                    window=window, q_offset=idx,
                                    kv_valid_len=idx + S,
                                    q_block=cfg.q_block,
                                    kv_block=cfg.kv_block)
    else:
        out = chunked_attention(q, k, v,
                                causal=causal and cross_states is None,
                                window=window, q_block=cfg.q_block,
                                kv_block=cfg.kv_block)

    out = constrain(out, "batch", None, "heads", None)
    out = dense(out.reshape(B, S, H * D), p["wo"])
    return out, new_cache
