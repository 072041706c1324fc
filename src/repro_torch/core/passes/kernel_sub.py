"""Kernel substitution (pipeline stage ``kernels``, DESIGN.md §10).

The hand-written kernels under ``repro_torch/kernels/`` are only reachable
from code that calls them directly; traced imperative programs spell the
same math as chains of fine-grained ops.  This pass closes the gap: it
pattern-matches traced subgraphs on the optimized clone and rewrites them
to single fused-kernel nodes.

Patterns:

* **paged decode** — a ``serve.slot_decode`` node stepping a paged pool is
  retargeted to ``kernel.slot_decode_paged``: same leaves, attrs and
  outputs, with the attention inner loop on the paged-attention kernel.
* **rms_norm** — the registered ``rms_norm`` op node is retargeted to
  ``kernel.rms_norm`` (the fused single-pass RMSNorm).  The kernel
  follows the ``(1 + g)`` weight convention, so the wrapper shifts the
  gain; outputs agree with the unfused op within f32-accumulation
  tolerance.
* **softmax attention** — ``einsum('bst,btd->bsd', softmax(scores), v)``
  where ``scores = einsum('bsd,btd->bst', q, k) * D**-0.5`` optionally
  plus a constant-evaluable additive bias.  A bias that equals the
  standard causal ``(tril - 1) * 1e9`` matches the kernel's ``causal``
  mask; an all-zero (or absent) bias matches full attention.  The whole
  chain is rewritten in place of its final node, so consumers and fetch
  annotations are untouched; the intermediates must have no consumers
  outside the pattern (in particular no ``.vjp`` tape consumers — a
  differentiated attention keeps its unfused form) and fall to DCE.

The pass only runs when requested: ``optimize="all"`` enables it on the
``"cuda"`` backend; elsewhere it must be named explicitly (the wrappers
then run their plain versions, which validate numerics but are not fast).
On the card a pattern is rewritten only when its kernel op has a Hopper
kernel (``CUDA_KERNEL_OPS``); all three have one, so the pass rewrites
the same nodes on ``"cuda"`` as on ``"cpu"`` and as the reference does on
a TPU.  ``kernel.attention`` hands the flash-attention wrapper
``q[:, None]`` views; the wrapper makes its inputs contiguous, which
copies nothing for the contiguous ``[B*H, S, D]`` operands a traced
attention chain has.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np

from repro_torch.core import ops as ops_mod
from repro_torch.core.passes.analysis import FoldedConst
from repro_torch.core.trace import as_tensor, to_numpy

Key = Tuple[int, int]

SCALE_RTOL = 1e-3
_CONST_EVAL_MAX = 32        # nodes per bias-chain evaluation

# kernel ops with a hand-written kernel on the card; an op missing here
# would be substituted only off the card, where every wrapper runs its
# plain version
CUDA_KERNEL_OPS = frozenset({"kernel.slot_decode_paged", "kernel.rms_norm",
                             "kernel.attention"})


# --------------------------------------------------------------------------
# Fused-kernel op registry entries (impl-level: graphgen executes these)
# --------------------------------------------------------------------------

def _krms_impl(x, g, *, eps=1e-6):
    from repro_torch.kernels import ops as kops
    return kops.rmsnorm(x, g - 1.0, eps=float(eps))


def _kattn_impl(q, k, v, *, causal=True):
    from repro_torch.kernels import ops as kops
    out = kops.flash_attention(q[:, None], k[:, None], v[:, None],
                               causal=bool(causal))
    return out[:, 0]


def _kpaged_decode_impl(*leaves, **attrs):
    from repro_torch.serve.scheduler import pool_ops
    return pool_ops._slot_decode_kernel_impl(*leaves, **attrs)


if "kernel.rms_norm" not in ops_mod.OPS:
    from repro_torch.serve.scheduler import inplace as _inplace
    ops_mod.def_op("kernel.rms_norm", _krms_impl)
    ops_mod.def_op("kernel.attention", _kattn_impl)
    ops_mod.def_op("kernel.slot_decode_paged", _kpaged_decode_impl,
                   inplace=_inplace.in_place_form(_kpaged_decode_impl),
                   writes=_inplace.pool_writes)
    ops_mod._NONDIFF_OPS.update({"kernel.rms_norm", "kernel.attention",
                                 "kernel.slot_decode_paged"})


def _paged_decode_meta(n) -> bool:
    """True when a ``serve.slot_decode`` node steps a paged pool — the
    only decode class the paged-attention kernel applies to."""
    try:
        from repro_torch.serve.scheduler import pool_ops
        return pool_ops.pool_meta(dict(n.attrs)["_meta"]).page_size > 0
    except Exception:
        return False


# --------------------------------------------------------------------------
# Matching helpers
# --------------------------------------------------------------------------

def _producer(otg, opt, src):
    if src[0] != "node":
        return None
    n = otg.nodes[src[1]]
    if n.kind != "op" or n.uid in opt.dead or n.uid in opt.alias_nodes:
        return None
    return n if src[2] == 0 else None


def _const_of(src):
    if src[0] != "const":
        return None
    v = src[1]
    return v.value if isinstance(v, FoldedConst) else v


def _const_eval(otg, src, memo: Dict, visited: Set[int]):
    """Evaluate a source whose transitive leaves are all constants, or
    return None.  ``visited`` collects the chain's node uids."""
    c = _const_of(src)
    if c is not None:
        return np.asarray(c)
    if src[0] != "node":
        return None
    key = (src[1], src[2])
    if key in memo:
        return memo[key]
    if len(visited) > _CONST_EVAL_MAX:
        return None
    n = otg.nodes[src[1]]
    if n.kind != "op":
        return None
    vals = []
    for s in n.srcs:
        v = _const_eval(otg, s, memo, visited)
        if v is None:
            return None
        vals.append(as_tensor(v))
    visited.add(n.uid)
    out = ops_mod.OPS[n.op_name].impl(*vals, **dict(n.attrs))
    outs = out if isinstance(out, tuple) else (out,)
    for oi, v in enumerate(outs):
        memo[(n.uid, oi)] = to_numpy(v)
    return memo.get(key)


def _consumers(otg, opt) -> Dict[Key, Set[int]]:
    cons: Dict[Key, Set[int]] = {}
    for uid, n in otg.nodes.items():
        if n.kind not in ("op", "loop"):
            continue
        for s in opt.eff_srcs(n):
            if s[0] == "node":
                cons.setdefault((s[1], s[2]), set()).add(uid)
    return cons


def _only_consumed_by(cons, node, allowed: Set[int]) -> bool:
    if node.fetch_idxs or node.var_assigns:
        return False
    for oi in range(len(node.out_avals)):
        if cons.get((node.uid, oi), set()) - allowed:
            return False
    return True


def _match_attention(otg, opt, cons, final) -> Optional[Tuple]:
    """final: einsum('bst,btd->bsd', <softmax>, v).  Returns
    (q_src, k_src, v_src, causal, interior_uids) or None."""
    sm = _producer(otg, opt, final.srcs[0])
    if sm is None or sm.op_name != "softmax":
        return None
    if dict(sm.attrs).get("axis", -1) != -1:
        return None
    scores = _producer(otg, opt, sm.srcs[0])
    if scores is None:
        return None
    bias = None
    if scores.op_name == "add":
        scaled = _producer(otg, opt, scores.srcs[0])
        bias_src = scores.srcs[1]
        if scaled is None or scaled.op_name != "mul":
            scaled = _producer(otg, opt, scores.srcs[1])
            bias_src = scores.srcs[0]
        if scaled is None or scaled.op_name != "mul":
            return None
        bias = _const_eval(otg, bias_src, {}, set())
        if bias is None:
            return None
        add_node = scores
    elif scores.op_name == "mul":
        scaled, add_node = scores, None
    else:
        return None
    scale, e_src = _const_of(scaled.srcs[1]), scaled.srcs[0]
    if scale is None:
        scale, e_src = _const_of(scaled.srcs[0]), scaled.srcs[1]
    if scale is None or np.ndim(scale) != 0:
        return None
    e = _producer(otg, opt, e_src)
    if e is None or e.op_name != "einsum" \
            or dict(e.attrs).get("expr") != "bsd,btd->bst":
        return None
    q_src, k_src = e.srcs
    v_src = final.srcs[1]
    q_aval = _src_aval(otg, opt, q_src)
    if q_aval is None or len(q_aval.shape) != 3:
        return None
    d = q_aval.shape[-1]
    if not np.isclose(float(scale), d ** -0.5, rtol=SCALE_RTOL):
        return None
    if bias is not None:
        if bias.ndim != 2:
            return None
        causal_bias = (np.tril(np.ones(bias.shape, np.float32)) - 1.0) * 1e9
        if np.allclose(bias, causal_bias, atol=1.0):
            causal = True
        elif np.allclose(bias, 0.0, atol=1e-6):
            causal = False
        else:
            return None
    else:
        causal = False
    interior = {e.uid, scaled.uid, sm.uid}
    if add_node is not None:
        interior.add(add_node.uid)
    allowed = interior | {final.uid}
    for uid in interior:
        if not _only_consumed_by(cons, otg.nodes[uid], allowed):
            return None
    return q_src, k_src, v_src, causal, interior


def _src_aval(otg, opt, src):
    if src[0] == "node":
        n = otg.nodes[src[1]]
        if n.kind != "op":
            return None
        return n.out_avals[src[2]]
    if src[0] == "feed":
        return src[1]
    if src[0] == "var":
        return opt_var_aval(opt, src[1])
    return None


def opt_var_aval(opt, var_id):
    return getattr(opt, "_var_avals", {}).get(var_id)


def run(ctx) -> None:
    otg, opt = ctx.otg, ctx.opt
    opt._var_avals = ctx.var_avals or {}
    cons = _consumers(otg, opt)
    substituted = 0

    def wanted(kop: str) -> bool:
        return ctx.backend != "cuda" or kop in CUDA_KERNEL_OPS

    for uid in list(otg.nodes):
        n = otg.nodes[uid]
        if n.kind != "op" or uid in opt.dead or uid in opt.alias_nodes:
            continue
        if n.op_name == "serve.slot_decode" and _paged_decode_meta(n):
            # same leaves, same attrs, same outputs — only the attention
            # inner loop changes (paged kernel vs gather + dense softmax)
            n.op_name = "kernel.slot_decode_paged"
            n._sig_cache = None
            substituted += 1
        elif n.op_name == "rms_norm" and wanted("kernel.rms_norm"):
            g_aval = _src_aval(otg, opt, n.srcs[1]) if len(n.srcs) > 1 else None
            x_aval = _src_aval(otg, opt, n.srcs[0]) if n.srcs else None
            if (g_aval is None or x_aval is None
                    or len(g_aval.shape) != 1
                    or g_aval.shape[0] != x_aval.shape[-1]):
                continue
            n.op_name = "kernel.rms_norm"
            n._sig_cache = None
            substituted += 1
        elif (n.op_name == "einsum" and wanted("kernel.attention")
                and dict(n.attrs).get("expr") == "bst,btd->bsd"):
            m = _match_attention(otg, opt, cons, n)
            if m is None:
                continue
            q_src, k_src, v_src, causal, interior = m
            e_uid = next(u for u in interior
                         if otg.nodes[u].op_name == "einsum")
            old_slots = {0: (e_uid, 0), 1: (e_uid, 1), 2: (uid, 1)}
            n.op_name = "kernel.attention"
            n.attrs = (("causal", causal),)
            n.srcs = (q_src, k_src, v_src)
            for pos, src in enumerate(n.srcs):
                if src[0] == "feed":
                    opt.feed_moved[(uid, pos)] = old_slots[pos]
            n._sig_cache = None
            substituted += 1
            cons = _consumers(otg, opt)   # srcs changed: rebuild
    if substituted:
        opt.bump("kernels_substituted", substituted)
