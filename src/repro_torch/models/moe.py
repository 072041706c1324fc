"""Mixture-of-Experts: top-k router + capacity-bounded sort-free dispatch.

The counterpart of the reference's ``models/moe.py:moe_block``: the
Switch-Transformer position-in-expert construction (an exclusive cumsum
over one-hot assignments), a scatter into per-expert buffers
``[E, C + 1, d]`` whose row C collects every dropped token, one batched
SwiGLU per expert, then a gather back and a gate-weighted sum.  DeepSeek-
MoE's fine-grained routing (64 routed + 2 shared experts, top-6) is the
same path with ``n_shared_experts`` > 0.

Every shape here is static (C comes from the token count, never from the
routing), and nothing reads the device on the host, so a decode step that
holds this block is captured whole as a CUDA graph.  The products are
plain ``torch.bmm``: the reference leaves them to XLA, outside any Pallas
kernel.  Expert parallelism (``moe_impl="shard_map"``) is
``models/moe_ep.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, mlp_swiglu
from repro_torch.parallel.sharding import (constrain, current_policy,
                                           is_dtensor)
from repro_torch.parallel.specs import mesh_view
from repro_torch.parallel.sharding import gathered as weight


def capacity(cfg, T: int) -> int:
    """Slots per expert for ``T`` tokens (the reference's rule)."""
    C = int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts)
    return max(8, min(C, T))


def route(logits, K: int):
    """Top-``K`` of f32 router logits -> (weights [T, K] f32 softmaxed over
    the K, expert ids [T, K]).  A stable descending sort gives equal
    logits in index order, as ``jax.lax.top_k`` does, so ties pick the
    same experts (and so drop the same tokens) as the reference."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :K], dim=-1), ids[:, :K]


def _moe_axes(E: int):
    """The buffers' logical axes under a mesh (the reference's rule):
    experts over the expert axes when those divide E, else capacity over
    its axes."""
    pol = current_policy()
    if pol is None or pol.mesh is None:
        return "expert", None
    sizes = mesh_view(pol.mesh).shape
    axes = tuple(a for a in pol.rules.get("expert", ()) if a in sizes)
    size = 1
    for a in axes:
        size *= sizes[a]
    if axes and E % size == 0:
        return "expert", None
    return None, "capacity"


def moe_block(p, x, cfg):
    """x: [B, S, d] -> [B, S, d]."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)

    # ---- router ----------------------------------------------------------
    logits = dense(xt.float(), p["w_router"].float())          # [T, E]
    gate_w, gate_ids = route(logits, K)                         # [T, K]
    gate_w = gate_w.to(x.dtype)

    # ---- capacity + position-in-expert ------------------------------------
    C = capacity(cfg, T)
    flat_ids = gate_ids.reshape(-1)                             # [T*K]
    experts = torch.arange(E, device=x.device)
    onehot = (flat_ids[:, None] == experts).to(torch.int32)     # [T*K, E]
    pos_in_exp = torch.cumsum(onehot, 0) - onehot               # exclusive
    pos = (pos_in_exp * onehot).sum(1)                          # [T*K]
    keep = pos < C
    slot = torch.where(keep, pos, C)                            # C: drop row

    # ---- dispatch: scatter tokens into [E, C+1, d] -------------------------
    # each kept (expert, slot) is written exactly once, so kept rows are
    # exact and need no accumulation (the reference's ``.at[].add`` onto
    # zeros); only row C, the dropped tokens' row, is written more than
    # once, and it is cut off.  Under a mesh the tokens are a DTensor and
    # the zeros a plain tensor, which an in-place write cannot mix: there
    # the write is out of place
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    if is_dtensor(xt):
        buf = buf.index_put((flat_ids, slot), xt[tok_idx])
    else:
        buf.index_put_((flat_ids, slot), xt[tok_idx])
    e_ax, c_ax = _moe_axes(E)
    buf = constrain(buf[:, :C], e_ax, c_ax, None)               # [E, C, d]

    # ---- expert FFNs -------------------------------------------------------
    h = F.silu(torch.bmm(buf, weight(p["w_gate"]))) \
        * torch.bmm(buf, weight(p["w_up"]))
    h = constrain(h, e_ax, c_ax, "d_ff")
    out_buf = constrain(torch.bmm(h, weight(p["w_down"])), e_ax, c_ax,
                        None)

    # ---- combine: gather back and weight ------------------------------------
    gathered = out_buf[flat_ids, torch.clamp_max(slot, C - 1)]  # [T*K, d]
    gathered = gathered * keep[:, None].to(x.dtype)
    combined = (gathered.reshape(T, K, d) * gate_w[..., None]).sum(1)

    # ---- shared experts (DeepSeek-MoE) -------------------------------------
    if cfg.n_shared_experts:
        combined = combined + mlp_swiglu(p["shared"], xt)

    return combined.reshape(B, S, d)
