"""The least time a kernel call's inputs need: each input byte read once,
each output byte written once, and the operations the algorithm needs, at
the chip's published peaks; the larger of the two.  Frozen copies of the
bound functions the port's kernel checks use, in plain numbers (shapes,
lengths and element sizes) instead of tensors."""

from __future__ import annotations

from portbench.roofline.peaks import HBM_BYTES_PER_S, OPS_PER_S

SSD_CHUNK = 64      # the SSD kernels' chunk


def _ms(nbytes, ops, dtype):
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[dtype])


def paged_bound_ms(valid, Hq, Hkv, D, bs, el=2, window=0,
                   dtype="bfloat16") -> float:
    """Paged single-token decode over rows of ``valid`` lengths: each
    valid (in-window) K/V position read once, q read and the output
    written once, the table entries of the blocks read; 4·Hq·D
    operations per position."""
    B = len(valid)
    pos = [min(v, window) if window else v for v in valid]
    blocks = sum(-(-v // bs) for v in valid)
    q_numel = B * Hq * D
    nbytes = (sum(pos) * Hkv * D * 2 * el + 2 * q_numel * el
              + blocks * 4 + B * 4)
    ops = 4 * sum(pos) * Hq * D
    return _ms(nbytes, ops, dtype)


def ssd_pairs(S: int, Q: int = SSD_CHUNK) -> int:
    """The causal (i >= j) token pairs of the kernels' chunks over S
    tokens, a ragged last chunk at its own length."""
    r = S % Q
    return S // Q * Q * (Q + 1) // 2 + r * (r + 1) // 2


def ssd_bwd_bound_ms(B, S, H, P, N, el=2, del_=2, final=False,
                     dtype="bfloat16") -> float:
    """The SSD scan's gradient: x, dt, B, C and dy read once (and the
    final state's cotangent), their gradients and dA written once; per
    causal pair of a chunk C·Bᵀ (N) and per head dy·uᵀ and Mᵀ·dy (P each)
    and the intra-chunk dB and dC (N each), per token and head five
    [P, N] products; two operations per multiply-add."""
    nbytes = (3 * B * S * H * P * el + 4 * B * S * N * el + 2 * B * S * H
              * del_ + 2 * H * 4 + (B * H * P * N * 4 if final else 0))
    ops = 2 * B * (ssd_pairs(S) * (N + H * (2 * P + 2 * N))
                   + S * H * 5 * P * N)
    return _ms(nbytes, ops, dtype)


def attn_bound_ms(B, H, Sq, Skv, D, pairs, el=2, dtype="bfloat16") -> float:
    """Attention: q/k/v read once, the output written once; 4·D
    operations per unmasked (query, key) pair."""
    nbytes = 2 * B * H * Sq * D * el + 2 * B * H * Skv * D * el
    return _ms(nbytes, 4 * D * B * H * pairs, dtype)
