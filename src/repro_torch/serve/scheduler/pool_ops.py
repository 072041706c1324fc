"""Slot-pool DL operations: ``serve.slot_prefill`` / ``serve.slot_decode``.

The continuous-batching scheduler keeps one fixed KV/recurrent cache for
the whole engine lifetime; requests borrow slots and return them at
retirement.  Both pool mutations are registered DL ops (core op registry,
DESIGN.md §2 granularity), so under Terra co-execution they land in the
TraceGraph as single nodes whose input/output leaves are the pool cache
Variables:

* ``serve.slot_prefill`` — run the model over a length-bucketed prompt
  batch against a *fresh* batch-local cache, sample the first token at
  each row's true last position, then scatter the batch rows into the
  pool at the assigned slot indices and set the per-slot position
  counters to the prompt lengths.
* ``serve.slot_decode`` — one masked decode step over *all* slots: each
  row attends at its own position (vector ``cache["len"]``, see
  models/attention.py), the new K/V lands at that row's position, and
  only *active* rows advance their counter / produce a real token.
  Inactive rows compute garbage that stays beyond their valid length —
  masked at every future read and overwritten by the next prefill into
  that slot — so slot churn never changes the op's shape.

The sampled-token frame ``tokf`` [max_slots, 1] is threaded *on device*:
decode embeds it directly and writes the frame for the next step
(``where(mask, tok, tokf)``); prefill scatters each admitted row's first
token into it.  The host therefore never needs step N's token to
dispatch step N+1 — the scheduler fetches the token frame one step late,
purely for delivery (DESIGN.md §12).

Paged mode (``page_size > 0``): attention K/V leaves become flat block
arenas ``[num_blocks, page_size, Hkv, D]`` addressed through a per-slot
block table ``bt`` [max_slots, nbps] fed each step; recurrent leaves
(O(1) state per slot) stay dense.  Prefill scatters whole bucket rows
block-wise through the admitted rows' tables (``bt_rows`` [b, nbps]).

Every update writes into a fresh tensor (a clone), never into a pool
buffer the engine's store or a rollback snapshot still holds; the ops'
in-place forms (inplace.py) are for callers that own the pool.

Pytrees are flattened at the op boundary; a meta registry keeps the
(static) treedefs and per-leaf scatter axes out of band.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Tuple

import torch

from repro_torch.core.capture import CaptureContext, jit_disabled
from repro_torch.core.ops import OPS, _uniform01, def_op
from repro_torch.core.pytree import (tree_flatten, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serve.meta import MetaRegistry
from repro_torch.serve.scheduler.inplace import (in_place, in_place_form,
                                                 pool_writes)

# kinds whose cache reads tolerate right-padding (garbage entries beyond
# the valid length are masked out by the attention valid-length mask);
# recurrent kinds fold every position into their state, so their prompts
# are admitted at exact length (no padding), but for MASKED_KINDS: their
# prefill takes each row's length (``lengths``: dt zeroed and the conv
# window read at it), so padding leaves the state at the last real token.
# ``ssd`` could too; it keeps the reference scheduler's exact-length
# admission, which the port's serving tests hold it to
PAD_SAFE_KINDS = ("attn", "attn_swa", "attn_local", "moe")
RECURRENT_KINDS = T.SSD_KINDS + ("rglru",)
MASKED_KINDS = ("ssd_moe",)


def check_supported(cfg) -> None:
    """The slot pool supports self-attention and recurrent decoder stacks;
    encoder/cross-attention families need per-request side inputs that the
    pooled step has no lane for yet — the lock-step engine serves those."""
    kinds = tuple(cfg.block_pattern) + tuple(cfg.extra_blocks)
    bad = [k for k in kinds if k not in PAD_SAFE_KINDS + RECURRENT_KINDS]
    if bad or cfg.enc_layers:
        raise NotImplementedError(
            f"slot-pooled scheduling does not support {cfg.name}: block "
            f"kinds {bad or ['encoder']} need per-request cross/frontend "
            "state; use ServingEngine.run_batch for this family")


def pads_allowed(cfg) -> bool:
    """True when prompts may be right-padded to their length bucket."""
    kinds = tuple(cfg.block_pattern) + tuple(cfg.extra_blocks)
    return all(k in PAD_SAFE_KINDS + MASKED_KINDS for k in kinds)


def build_pool_cache(cfg, max_slots: int, max_len: int, page_size: int = 0,
                     num_blocks: int = 0, device=None):
    """Zero-initialised pool cache on ``device``: ``init_cache`` minus the
    scalar ``len`` (replaced by the per-slot position vector).  Returns
    (leaves, treedef, batch_axes, paged): ``batch_axes[i]`` is the slot
    axis of leaf i — stacked layer caches carry a leading n_pattern_blocks
    axis, extra-block caches do not — and ``paged[i]`` marks leaves laid
    out as block arenas instead of slot rows.  Recurrent leaves (``ssd``
    and ``rglru`` conv windows and states) stay dense slot rows under a
    page size."""
    dt = getattr(torch, cfg.dtype)

    def slot(kind, nb):
        if page_size and kind in PAD_SAFE_KINDS:
            Hkv, D = cfg.n_kv_heads, cfg.head_dim
            shp = (num_blocks, page_size, Hkv, D)
            shp = (nb,) + shp if nb is not None else shp
            return {"kp": torch.zeros(shp, dtype=dt, device=device),
                    "vp": torch.zeros(shp, dtype=dt, device=device)}
        return M._slot_cache(cfg, kind, nb, max_slots, max_len, device)

    nb = cfg.n_pattern_blocks
    tmpl = {"layers": [slot(k, nb) for k in cfg.block_pattern],
            "extra": [slot(k, None) for k in cfg.extra_blocks]}
    axes_tree = {"layers": tree_map(lambda _: 1, tmpl["layers"]),
                 "extra": tree_map(lambda _: 0, tmpl["extra"])}

    def pg_tree(kind, sub):
        flag = bool(page_size) and kind in PAD_SAFE_KINDS
        return tree_map(lambda _: flag, sub)

    pg = {"layers": [pg_tree(k, s)
                     for k, s in zip(cfg.block_pattern, tmpl["layers"])],
          "extra": [pg_tree(k, s)
                    for k, s in zip(cfg.extra_blocks, tmpl["extra"])]}
    leaves, treedef = tree_flatten(tmpl)
    axes = tree_leaves(axes_tree)
    paged = tree_leaves(pg)
    return leaves, treedef, tuple(axes), tuple(paged)


def _flatten_cache(cache) -> List[Any]:
    """Flatten a run_stack cache pytree in pool-leaf order (minus len)."""
    return tree_leaves({"layers": cache["layers"], "extra": cache["extra"]})


# --------------------------------------------------------------------------
# Meta registry: static treedefs/axes keyed by an attribute-sized id
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PoolMeta:
    cfg: Any
    params_def: Any
    cache_def: Any
    batch_axes: Tuple[int, ...]
    temperature: float
    max_len: int
    page_size: int = 0
    num_blocks: int = 0
    paged: Tuple[bool, ...] = ()


_META = MetaRegistry()


def register_pool_meta(cfg, params_def, cache_def, batch_axes,
                       temperature: float, max_len: int, page_size: int = 0,
                       num_blocks: int = 0, paged=()) -> int:
    return _META.register(PoolMeta(cfg, params_def, cache_def,
                                   tuple(batch_axes), float(temperature),
                                   int(max_len), int(page_size),
                                   int(num_blocks), tuple(paged)))


def pool_meta(mid: int) -> PoolMeta:
    return _META.get(mid)


# --------------------------------------------------------------------------
# Pure step bodies
# --------------------------------------------------------------------------

def _sample(logits, temperature: float, rng):
    """Greedy argmax (first maximum on ties), or — at temperature > 0 —
    Gumbel-max sampling with noise from the op layer's counter hash of
    the key feed (``core.ops._uniform01``): made where the key lies, with
    no host read, so a step samples inside a CUDA graph; equal keys give
    equal tokens on the CPU and on the card."""
    if temperature > 0.0 and rng is not None:
        u = _uniform01(rng.reshape(-1), logits.numel()).reshape(
            logits.shape)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        tok = torch.argmax(logits.float() / temperature + gumbel, dim=-1)
    else:
        tok = torch.argmax(logits, dim=-1)
    return tok.to(torch.int32)


def _pool_prefill(meta: PoolMeta, params, cache_leaves, pos, tokf, tokens,
                  slots, lengths, bt_rows, rng):
    """tokens [b, S] (padded to the bucket), slots/lengths [b] int32 ->
    (first token [b, 1], scattered pool leaves, updated pos, tokf)."""
    cfg = meta.cfg
    B, S = tokens.shape
    dev = tokens.device
    # batch-local cache at the pool's max_len: the same math as the
    # lock-step prefill (same shapes through run_stack), scattered whole-row
    fresh = M.init_cache(cfg, B, meta.max_len, dev)
    x = T.embed_tokens(cfg, params, tokens)
    # a padded recurrent prefill keeps each row's state at its own length
    x, fresh = T.run_stack(cfg, params, x,
                           positions=torch.arange(S, device=dev)[None],
                           caches=fresh,
                           lengths=lengths if pads_allowed(cfg) else None)
    x = T._norm(cfg, params["final_norm"], x)                  # [b, S, d]
    last = x[torch.arange(B, device=dev), lengths.long() - 1]  # [b, d]
    tok = _sample(T.head_logits(cfg, params, last), meta.temperature, rng)

    bs = meta.page_size
    slots = slots.long()
    own = A.cache_in_place_enabled()
    new_leaves = []
    for pool_leaf, b_leaf, ax, pg in zip(cache_leaves, _flatten_cache(fresh),
                                         meta.batch_axes, meta.paged):
        b_leaf = b_leaf.to(pool_leaf.dtype)
        new = pool_leaf if own else pool_leaf.clone()
        if pg:
            # block-wise scatter of the dense bucket rows through the
            # admitted rows' block tables; unassigned table tail entries
            # are 0 -> the trash block (never read)
            rows = bt_rows.long()
            if ax == 0:
                r = b_leaf.reshape((B, b_leaf.shape[1] // bs, bs)
                                   + tuple(b_leaf.shape[2:]))
                new[rows] = r
            else:
                nb_ = b_leaf.shape[0]
                r = b_leaf.reshape((nb_, B, b_leaf.shape[2] // bs, bs)
                                   + tuple(b_leaf.shape[3:]))
                new[:, rows] = r
        elif ax == 0:
            new[slots] = b_leaf
        else:
            new[:, slots] = b_leaf
        new_leaves.append(new)
    new_pos = pos if own else pos.clone()
    new_pos[slots] = lengths.to(pos.dtype)
    new_tokf = tokf if own else tokf.clone()
    new_tokf[slots] = tok[:, None]
    return (tok[:, None],) + tuple(new_leaves) + (new_pos, new_tokf)


def _pool_decode(meta: PoolMeta, params, cache_leaves, pos, tokf,
                 mask, bt, rng):
    """tokf [max_slots, 1], pos/mask [max_slots] -> (this step's token,
    updated pool leaves, advanced pos, next-step token frame).  One fixed
    shape class forever."""
    cfg = meta.cfg
    cache = tree_unflatten(meta.cache_def, cache_leaves)
    caches = {"layers": cache["layers"], "extra": cache["extra"],
              "len": pos}
    if bt is not None:
        caches["bt"] = bt
    x = T.embed_tokens(cfg, params, tokf)
    x, new_caches = T.run_stack(cfg, params, x, positions=pos[:, None],
                                caches=caches)
    x = T._norm(cfg, params["final_norm"], x)
    tok = _sample(T.head_logits(cfg, params, x[:, 0]), meta.temperature,
                  rng)
    mask = mask.to(torch.bool)
    tok = torch.where(mask, tok, 0)[:, None]
    new_pos = pos + mask.to(pos.dtype)
    new_tokf = torch.where(mask[:, None], tok, tokf)
    return (tok,) + tuple(_flatten_cache(new_caches)) + (new_pos, new_tokf)


# --------------------------------------------------------------------------
# Registered DL ops (flat-leaf boundary)
# --------------------------------------------------------------------------

def _split(leaves, n_params: int, n_cache: int, meta_id: int):
    meta = _META.get(meta_id)
    params = tree_unflatten(meta.params_def, leaves[:n_params])
    cache_leaves = list(leaves[n_params:n_params + n_cache])
    rest = list(leaves[n_params + n_cache:])
    return meta, params, cache_leaves, rest


def _slot_prefill_impl(*leaves, _meta: int, _n_params: int, _n_cache: int,
                       _has_rng: bool):
    meta, params, cache_leaves, rest = _split(leaves, _n_params, _n_cache,
                                              _meta)
    pos, tokf, tokens, slots, lengths = rest[:5]
    rest = rest[5:]
    bt_rows = rest.pop(0) if meta.page_size else None
    rng = rest[0] if _has_rng else None
    with torch.no_grad():
        return _pool_prefill(meta, params, cache_leaves, pos, tokf, tokens,
                             slots, lengths, bt_rows, rng)


def _slot_decode_impl(*leaves, _meta: int, _n_params: int, _n_cache: int,
                      _has_rng: bool):
    meta, params, cache_leaves, rest = _split(leaves, _n_params, _n_cache,
                                              _meta)
    pos, tokf, mask = rest[:3]
    rest = rest[3:]
    bt = rest.pop(0) if meta.page_size else None
    rng = rest[0] if _has_rng else None
    with torch.no_grad():
        return _pool_decode(meta, params, cache_leaves, pos, tokf, mask, bt,
                            rng)


def _slot_decode_kernel_impl(*leaves, **attrs):
    """Paged decode with the paged-attention kernel enabled: the same
    math (and the same op signature) as ``serve.slot_decode``, with the
    attention inner loop on the hand-written kernel."""
    with A.paged_kernel():
        return _slot_decode_impl(*leaves, **attrs)


slot_prefill = def_op("serve.slot_prefill", _slot_prefill_impl,
                      inplace=in_place_form(_slot_prefill_impl),
                      writes=pool_writes)
slot_decode = def_op("serve.slot_decode", _slot_decode_impl,
                     inplace=in_place_form(_slot_decode_impl),
                     writes=pool_writes)


# --------------------------------------------------------------------------
# The ``use_terra=False`` baseline's step callables
# --------------------------------------------------------------------------

def baseline_steps(n_params: int, n_cache: int, attrs: dict, device):
    """``serve.slot_decode`` and ``serve.slot_prefill`` called directly,
    with the pool (cache leaves, pos, tokf) donated: written in place, as
    the reference's ``donate_argnums`` lets XLA do.  On a CUDA card each
    step shape is a CUDA graph of one CaptureContext (core/capture.py),
    as the reference jits them -> (decode, prefill, context or None)."""
    lo, hi = n_params, n_params + n_cache + 2
    ctx = (CaptureContext(device) if device.type == "cuda"
           and not jit_disabled() else None)
    fns = []
    for name in ("serve.slot_decode", "serve.slot_prefill"):
        fn = functools.partial(in_place, OPS[name].impl, lo, hi, attrs)
        fns.append(fn if ctx is None else ctx.wrap(fn, donate=range(lo, hi)))
    return fns[0], fns[1], ctx
