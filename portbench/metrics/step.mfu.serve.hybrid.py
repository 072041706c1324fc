"""The whole serving step's share of the chip's bf16 peak for the hybrid
stacks (Mamba-2 mixer and attention layers, each with an MoE FFN):
2·N_active model operations a token through the model (prompt tokens
prefilled, plus generated tokens that a decode step made: a request's
first token comes from its prefill) in the traced span, over its length.
N_active is counted here from the configuration's sizes."""

from portbench.roofline.peaks import BF16_OPS_PER_S


def active(m: dict) -> int:
    """Parameters a token uses: each layer's mixer (the Mamba-2 mixer's
    projections, conv, bias, step and decay rates, D skip and gated norm;
    or attention's four projections), its router, the routed experts it
    goes to and the shared ones, and the output head."""
    d, V, L = m["d_model"], m["vocab"], m["n_layers"]
    pattern = m["block_pattern"]
    per = L // len(pattern)
    H, P, N, K = (m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"],
                  m["conv_kernel"])
    di, dc = H * P, H * P + 2 * N
    mixer = d * (2 * di + 2 * N + H) + dc * K + dc + 3 * H + di + di * d
    Hq, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = d * Hq * D + 2 * d * Hkv * D + Hq * D * d
    moe = (m["top_k"] + m["n_shared_experts"]) * 3 * d * m["moe_d_ff"] \
        + d * m["n_experts"]
    n_attn = per * pattern.count("moe")
    n_ssd = per * pattern.count("ssd_moe")
    return n_ssd * mixer + n_attn * attn + L * moe + V * d


def read(ctx):
    d = ctx["traced"]
    if ctx["trace"] is None or d is None:
        return None
    m = ctx["config"]["model"]
    if "ssd_moe" not in m.get("block_pattern", ()):
        return None
    tokens = d["prefill_tokens"] + d["generated_tokens"] - d["admitted"]
    if tokens <= 0:
        return None
    return 100.0 * 2 * active(m) * tokens / (ctx["trace"].window_s
                                             * BF16_OPS_PER_S)
