"""Explicit expert-parallel MoE: local dispatch + all-to-all over the
``model`` process group.

The counterpart of the reference's ``models/moe_ep.py`` (there: shard_map
over the mesh and ``jax.lax.all_to_all``), the MaxText/Megatron
formulation:

  1. each rank routes its LOCAL tokens and scatters them into a local
     ``[E, C_loc, d]`` buffer — no cross-rank indexing;
  2. one ``all_to_all_single`` over the ``model`` group regroups by
     expert: ``[E, C_loc, d] -> [E/ep, ep*C_loc, d]``, aligning tokens with
     the expert weight shard resident on the rank;
  3. the local expert FFNs (batched matmuls);
  4. the reverse all-to-all returns expert outputs to the owning rank,
     which combines them with the gate weights.

Wire cost per rank per step = 2 x (top_k-expanded activations).

Requires ``n_experts % ep == 0`` (``ep``: the ``model`` axis size);
otherwise, and without a mesh, the block is ``models/moe.py``'s.  Under a
mesh the inputs may be DTensors or plain tensors (taken as replicated):
tokens are sharded over the batch axes that divide the batch, the expert
weights over ``model``; the result has the input's kind and placements.
Each all-to-all is ``dist.all_to_all_single`` in an autograd Function,
whose gradient is the same exchange of the output's gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, mlp_swiglu
from repro_torch.models.moe import moe_block, route
from repro_torch.parallel.sharding import as_dtensor, current_mesh


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all_single`` with equal chunks, as autograd sees it:
    its gradient is the same exchange of the output's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def _all_to_all(x, group):
    """Send chunk j of ``x``'s leading axis to rank j of ``group``; the
    result's chunk j came from rank j."""
    return _AllToAll.apply(x, group)


def _local_moe(p, xt, cfg, ep: int, group):
    """Per-rank body.  xt: [T_loc, d] local tokens; expert weights already
    sharded: p['w_*'] leading dim E/ep."""
    T, d = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    e_loc = E // ep

    logits = dense(xt.float(), p["w_router"].float())           # [T, E]
    gate_w, gate_ids = route(logits, K)
    gate_w = gate_w.to(xt.dtype)

    C = max(8, int(cfg.capacity_factor * T * K / E))
    flat_ids = gate_ids.reshape(-1)                             # [T*K]
    experts = torch.arange(E, device=xt.device)
    onehot = (flat_ids[:, None] == experts).to(torch.int32)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    keep = pos < C
    slot = torch.where(keep, pos, C)

    # 1. local dispatch buffer [E, C+1, d] (row C: the dropped tokens)
    tok_idx = torch.arange(T, device=xt.device).repeat_interleave(K)
    buf = torch.zeros((E, C + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((flat_ids, slot), xt[tok_idx])[:, :C]  # [E, C, d]

    # 2. all-to-all: expert group j to rank j, the received capacity
    #    blocks side by side — [E, C, d] -> [E/ep, ep*C, d]
    recv = _all_to_all(buf, group)                   # [ep*e_loc, C, d]
    buf = recv.reshape(ep, e_loc, C, d).transpose(0, 1).reshape(
        e_loc, ep * C, d)

    # 3. local expert FFNs
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out = torch.bmm(h, p["w_down"])                  # [E/ep, ep*C, d]

    # 4. reverse all-to-all: back to [E, C, d] on the owning rank, in the
    #    original slot layout
    out = out.reshape(e_loc, ep, C, d).transpose(0, 1)
    out = _all_to_all(out, group).reshape(E, C, d)

    # combine locally
    gathered = out[flat_ids, torch.clamp_max(slot, C - 1)]
    gathered = gathered * keep[:, None].to(xt.dtype)
    combined = (gathered.reshape(T, K, d) * gate_w[..., None]).sum(1)

    if cfg.n_shared_experts:
        combined = combined + mlp_swiglu(p["shared"], xt)
    return combined


def _local(t, mesh, placements):
    """The local shard of ``t`` (a DTensor, or a plain tensor taken as
    replicated) at ``placements``."""
    return as_dtensor(t, mesh).redistribute(mesh, placements).to_local()


def moe_block_ep(p, x, cfg):
    """x: [B, S, d] -> [B, S, d] via explicit EP.  Falls back to
    ``moe_block`` when no mesh is active or the experts do not divide the
    model axis."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names \
            or cfg.n_experts % mesh["model"].size() != 0:
        return moe_block(p, x, cfg)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names = mesh.mesh_dim_names
    ep = mesh["model"].size()
    B, S, d = x.shape
    # tokens: the batch over the (pod, data) axes that divide it (in mesh
    # order, as the reference's batch axes tuple), replicated over model
    xpl, div = [Replicate()] * mesh.ndim, 1
    for a in ("pod", "data"):
        if a in names and B % (div * mesh[a].size()) == 0:
            xpl[names.index(a)] = Shard(0)
            div *= mesh[a].size()
    rep = [Replicate()] * mesh.ndim
    experts = list(rep)
    experts[names.index("model")] = Shard(0)
    p_loc = {k: _local(p[k], mesh, experts if k != "w_router" else rep)
             for k in ("w_router", "w_gate", "w_up", "w_down")}
    if cfg.n_shared_experts:
        p_loc["shared"] = {k: _local(v, mesh, rep)
                           for k, v in p["shared"].items()}
    x_loc = _local(x, mesh, xpl)
    Bl = x_loc.shape[0]
    y = _local_moe(p_loc, x_loc.reshape(Bl * S, d), cfg, ep,
                   mesh.get_group("model")).reshape(Bl, S, d)
    y = DTensor.from_local(y, mesh, xpl, run_check=False,
                           shape=x.shape, stride=x.stride())
    if isinstance(x, DTensor):
        return y.redistribute(mesh, x.placements)
    return y.full_tensor()
