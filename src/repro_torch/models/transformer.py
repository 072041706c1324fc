"""Transformer assembly for every architecture of the registry.

The model is a stack of *super-blocks*: each applies the config's
``block_pattern`` once.  Parameters keep the reference's stacked layout —
nested dicts with a leading ``n_pattern_blocks`` axis per pattern slot —
so the flat leaf order (and the serving pool's Variables) match it leaf
for leaf.  The reference scans over that axis with ``jax.lax.scan``; here
a Python loop indexes it.

Block kinds: the ``attn`` kinds (llama-family), ``moe`` (Mixtral,
DeepSeek-MoE), ``ssd`` (Mamba-2), ``ssd_moe`` (a Mamba-2 mixer and an MoE
FFN: granite-4.0-h), ``rglru`` (RecurrentGemma), ``cross``
(the VLM's gated cross-attention), ``dec_attn_cross`` (Whisper's decoder)
and ``enc_attn`` (Whisper's bidirectional encoder, :func:`encode`).

Remat: with ``cfg.remat`` and autograd recording, each super-block runs
under ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps
its scanned body in ``jax.checkpoint`` (the encoder's layers always under
``"full"``, as the reference's): policy ``"full"`` keeps only the block's
input, ``"dots"`` also keeps every matmul output (selective
checkpointing, the counterpart of ``dots_saveable``), ``"attn_out"`` keeps
each block's input and attention output and recomputes the rest, the FFN
too (two checkpoint regions per attention block: the counterpart of
``save_only_these_names("attn_out")``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.events.spans import sub_span
from repro_torch.core.pytree import tree_map
from repro_torch.models import layers as L
from repro_torch.models.attention import (attention_block,
                                          cache_in_place_enabled)
from repro_torch.models.moe import moe_block
from repro_torch.models.moe_ep import moe_block_ep
from repro_torch.models.rglru import rglru_block
from repro_torch.models.ssm import mamba2_block
from repro_torch.parallel.sharding import constrain

ATTN_KINDS = ("attn", "attn_swa", "attn_local", "moe", "enc_attn")
SSD_KINDS = ("ssd", "ssd_moe")      # a Mamba-2 mixer; ssd_moe + MoE FFN
KINDS = ATTN_KINDS + SSD_KINDS + ("rglru", "cross", "dec_attn_cross")


def _check_kinds(cfg) -> None:
    kinds = tuple(cfg.block_pattern) + tuple(cfg.extra_blocks)
    bad = [k for k in kinds if k not in KINDS]
    if bad:
        raise ValueError(f"{cfg.name}: unknown block kinds {bad}")


# ==========================================================================
# Parameter initialization (per block kind)
# ==========================================================================

def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _attn_params(cfg, gen, stack, cross: bool = False):
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dt(cfg)
    p = {
        "wq": L.he_init(gen, (d, H * D), dt, stack),
        "wk": L.he_init(gen, (d, Hkv * D), dt, stack),
        "wv": L.he_init(gen, (d, Hkv * D), dt, stack),
        "wo": L.he_init(gen, (H * D, d), dt, stack),
    }
    if cfg.qkv_bias and not cross:      # cross projections have no bias
        for name, n in (("bq", H * D), ("bk", Hkv * D), ("bv", Hkv * D)):
            p[name] = torch.zeros(tuple(stack) + (n,), dtype=dt,
                                  device=gen.device)
    return p


def _mlp_params(cfg, gen, stack, d_ff=None):
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, _dt(cfg)
    return {
        "w_gate": L.he_init(gen, (d, f), dt, stack),
        "w_up": L.he_init(gen, (d, f), dt, stack),
        "w_down": L.he_init(gen, (f, d), dt, stack),
    }


def _moe_params(cfg, gen, stack):
    """The reference's layout: an f32 router, expert weights [E, d, f] /
    [E, f, d] (He-scaled by their leading axis, as the reference's
    ``he_init`` takes it), and the shared experts as one wider MLP."""
    d, E, dt = cfg.d_model, cfg.n_experts, _dt(cfg)
    f = cfg.moe_d_ff or cfg.d_ff
    p = {
        "w_router": L.he_init(gen, (d, E), torch.float32, stack),
        "w_gate": L.he_init(gen, (E, d, f), dt, stack),
        "w_up": L.he_init(gen, (E, d, f), dt, stack),
        "w_down": L.he_init(gen, (E, f, d), dt, stack),
    }
    if cfg.n_shared_experts:
        p["shared"] = _mlp_params(cfg, gen, stack,
                                  d_ff=f * cfg.n_shared_experts)
    return p


def _ssd_params(cfg, gen, stack):
    d = cfg.d_model
    H, P, N, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_kernel
    d_inner = H * P
    dc = d_inner + 2 * N
    dt = _dt(cfg)
    p = {
        "w_in": L.he_init(gen, (d, 2 * d_inner + 2 * N + H), dt, stack),
        "w_conv": L.trunc_normal(gen, tuple(stack) + (dc, K), dt, 0.1),
        "dt_bias": torch.zeros(tuple(stack) + (H,), dtype=dt,
                               device=gen.device),
        # the decay rates stay float32 whatever param_dtype is
        "a_log": torch.zeros(tuple(stack) + (H,), dtype=torch.float32,
                             device=gen.device),
        "w_out": L.he_init(gen, (d_inner, d), dt, stack),
    }
    # Mamba-2's layer options (the config's port-only fields)
    if cfg.conv_bias:
        p["b_conv"] = torch.zeros(tuple(stack) + (dc,), dtype=dt,
                                  device=gen.device)
    if cfg.ssm_d_skip:
        p["d_skip"] = torch.ones(tuple(stack) + (H,), dtype=dt,
                                 device=gen.device)
    if cfg.ssm_gated_norm:
        p["norm"] = {"scale": torch.zeros(tuple(stack) + (d_inner,),
                                          dtype=dt, device=gen.device)}
    return p


def _rglru_params(cfg, gen, stack):
    d, dr, K, dt = cfg.d_model, cfg.rglru_width, cfg.conv_kernel, _dt(cfg)

    def zeros(n):
        return torch.zeros(tuple(stack) + (n,), dtype=dt, device=gen.device)
    return {
        "w_in_x": L.he_init(gen, (d, dr), dt, stack),
        "w_in_y": L.he_init(gen, (d, dr), dt, stack),
        "w_conv": L.trunc_normal(gen, tuple(stack) + (dr, K), dt, 0.1),
        "w_a": L.he_init(gen, (dr, dr), dt, stack),
        "b_a": zeros(dr),
        "w_x": L.he_init(gen, (dr, dr), dt, stack),
        "b_x": zeros(dr),
        # the decay parameter stays float32 whatever param_dtype is
        "lam": torch.full(tuple(stack) + (dr,), 0.7, dtype=torch.float32,
                          device=gen.device),
        "w_out": L.he_init(gen, (dr, d), dt, stack),
    }


def _norm_params(cfg, device, stack=()):
    shp = tuple(stack) + (cfg.d_model,)
    dt = _dt(cfg)
    if cfg.norm == "ln":
        return {"scale": torch.ones(shp, dtype=dt, device=device),
                "bias": torch.zeros(shp, dtype=dt, device=device)}
    return {"scale": torch.zeros(shp, dtype=dt, device=device)}


def _block_params(cfg, gen, kind: str, stack=()):
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    p = {"norm1": _norm_params(cfg, gen.device, stack)}
    if kind in SSD_KINDS:
        p["ssd"] = _ssd_params(cfg, gen, stack)
        if kind == "ssd":           # attention-free: no norm2, no MLP
            return p
        p["norm2"] = _norm_params(cfg, gen.device, stack)
        p["moe"] = _moe_params(cfg, gen, stack)
        return p
    if kind == "rglru":
        p["rglru"] = _rglru_params(cfg, gen, stack)
    elif kind == "cross":
        p["cross"] = _attn_params(cfg, gen, stack, cross=True)
    else:
        p["attn"] = _attn_params(cfg, gen, stack)
    p["norm2"] = _norm_params(cfg, gen.device, stack)
    if kind == "dec_attn_cross":
        p["cross"] = _attn_params(cfg, gen, stack, cross=True)
        p["norm3"] = _norm_params(cfg, gen.device, stack)
    if kind == "moe":
        p["moe"] = _moe_params(cfg, gen, stack)
    else:
        p["mlp"] = _mlp_params(cfg, gen, stack)
    if kind == "cross":             # gated cross-attention (llama 3.2)
        p["gate"] = torch.zeros(tuple(stack) + (1,), dtype=_dt(cfg),
                                device=gen.device)
    return p


class _MetaGenerator:
    """Stands in for a generator on the ``meta`` device, which torch does
    not have: the initializers read only its ``device``."""
    device = torch.device("meta")


def init_params(cfg: ModelConfig, generator=None, *, device=None
                ) -> Dict[str, Any]:
    """Random parameters in the reference's nesting and leaf order, made
    on ``device`` (default: the CUDA card) from ``generator`` (default: a
    generator on that device seeded with 0)."""
    cfg.validate()
    _check_kinds(cfg)
    dev = resolve_device(device)
    if generator is None:
        # meta: shapes only (model.abstract_params)
        generator = (_MetaGenerator() if dev.type == "meta"
                     else torch.Generator(dev).manual_seed(0))
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params "
                         f"requested on {dev}")
    nb = cfg.n_pattern_blocks
    dt = _dt(cfg)
    params: Dict[str, Any] = {
        "embed": L.trunc_normal(generator, (cfg.vocab, cfg.d_model), dt,
                                cfg.d_model ** -0.5),
        "final_norm": _norm_params(cfg, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.trunc_normal(
            generator, (cfg.vocab, cfg.d_model), dt, cfg.d_model ** -0.5)
    params["blocks"] = [_block_params(cfg, generator, kind, (nb,))
                        for kind in cfg.block_pattern]
    params["extra"] = [_block_params(cfg, generator, k)
                       for k in cfg.extra_blocks]
    if cfg.enc_layers:
        params["encoder"] = _block_params(cfg, generator, "enc_attn",
                                          (cfg.enc_layers,))
        params["enc_final_norm"] = _norm_params(cfg, generator.device)
        params["enc_pos"] = L.trunc_normal(
            generator, (cfg.frontend_tokens or 1500, cfg.d_model), dt, 0.02)
    return params


# ==========================================================================
# Forward
# ==========================================================================

def _norm(cfg, p, x):
    # under a mesh the residual stream may be a partial sum (a row-parallel
    # projection's output): it is reduced here, in the stream's dtype, not
    # after the norm's f32 upcast at twice the bytes
    x = constrain(x, "batch", *(None,) * (x.ndim - 1))
    if cfg.norm == "ln":
        return L.layer_norm(x, p["scale"], p["bias"])
    return L.rms_norm(x, p["scale"], cfg.norm_eps)


def _with_len(cache, cache_len, cache_bt):
    if cache is None:
        return None
    c = {**cache, "len": cache_len}
    if cache_bt is not None and "kp" in c:
        c["bt"] = cache_bt
    return c


def _strip_len(cache):
    return None if cache is None else {k: v for k, v in cache.items()
                                       if k not in ("len", "bt")}


def block_forward(cfg, kind: str, p, x, *, positions, cache=None,
                  cache_len=None, cache_bt=None, cross_states=None,
                  causal=True, split_remat=False, lengths=None):
    """One block of kind ``kind``.  Returns (x, new_cache).

    Attention caches are stored per layer as {"k","v"} (dense rows) or
    {"kp","vp"} (paged block arenas); the shared fill length — and, for
    paged caches, the shared block table ``cache_bt`` — is threaded
    separately so layer caches can be stacked.  SSD caches are
    {"conv","ssm"} and RG-LRU caches {"conv","h"}; they take neither.
    A ``cross`` block has no cache (None passes through); its and
    ``dec_attn_cross``'s cross-attention reads ``cross_states``.
    ``split_remat`` (remat policy ``"attn_out"``, no cache): an attention
    kind runs as two checkpoint regions, any other kind as one.
    ``lengths`` [B] (a prefill padded past each row's length, SSD kinds
    only): see ``ssm.mamba2_block``.  Inside a span that asked for its
    sub-spans (the scheduler's ``step.prefill``), each mixer, attention
    and MoE sub-layer is a device-timed ``step.prefill.<part>`` span.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    if split_remat and kind not in ATTN_KINDS:
        return ckpt.checkpoint(block_forward, cfg, kind, p, x,
                               positions=positions,
                               cross_states=cross_states, causal=causal,
                               use_reentrant=False)
    if kind in SSD_KINDS:
        with sub_span("step.prefill.mixer"):
            h, new_cache = mamba2_block(p["ssd"], _norm(cfg, p["norm1"], x),
                                        cfg, cache=cache, lengths=lengths)
        x = _residual(cfg, x, h)
        if kind == "ssd_moe":
            x = _ffn_half(cfg, "moe", p, x)
        return x, new_cache
    if kind == "rglru":
        h, new_cache = rglru_block(p["rglru"], _norm(cfg, p["norm1"], x),
                                   cfg, cache=cache)
        x = _residual(cfg, x, h)
        x = _residual(cfg, x, L.mlp_swiglu(p["mlp"],
                                           _norm(cfg, p["norm2"], x)))
        return x, new_cache
    if kind == "cross":
        h, _ = attention_block(p["cross"], _norm(cfg, p["norm1"], x), cfg,
                               positions=positions,
                               cross_states=cross_states)
        x = _residual(cfg, x, torch.tanh(p["gate"]) * h)
        x = _residual(cfg, x, L.mlp_swiglu(p["mlp"],
                                           _norm(cfg, p["norm2"], x)))
        return x, cache             # cross caches are static
    if kind == "dec_attn_cross":
        h, new_cache = attention_block(
            p["attn"], _norm(cfg, p["norm1"], x), cfg, positions=positions,
            cache=_with_len(cache, cache_len, cache_bt), causal=True)
        x = _residual(cfg, x, h)
        h, _ = attention_block(p["cross"], _norm(cfg, p["norm2"], x), cfg,
                               positions=positions,
                               cross_states=cross_states)
        x = _residual(cfg, x, h)
        x = _residual(cfg, x, L.mlp_swiglu(p["mlp"],
                                           _norm(cfg, p["norm3"], x)))
        return x, _strip_len(new_cache)
    if split_remat:
        # remat policy "attn_out": the attention sub-layer and the FFN are
        # two checkpoint regions, so the block input and the attention
        # output are kept and everything else (the FFN too) is recomputed
        h = ckpt.checkpoint(_attention_half, cfg, kind, p, x, positions,
                            causal, use_reentrant=False)[0]
        return ckpt.checkpoint(_ffn_half, cfg, kind, p,
                               _residual(cfg, x, h),
                               use_reentrant=False), None
    with sub_span("step.prefill.attention"):
        h, new_cache = _attention_half(cfg, kind, p, x, positions, causal,
                                       cache=_with_len(cache, cache_len,
                                                       cache_bt))
    return _ffn_half(cfg, kind, p, _residual(cfg, x, h)), \
        _strip_len(new_cache)


def _residual(cfg, x, h):
    """``x + h``, the branch scaled by ``cfg.residual_multiplier``."""
    if cfg.residual_multiplier != 1.0:
        h = h * cfg.residual_multiplier
    return x + h


def _attention_half(cfg, kind, p, x, positions, causal, cache=None):
    """The self-attention sub-layer of an attention-kind block: its output
    (the reference's named ``"attn_out"``), with the new cache when one
    was given."""
    window = {"attn_swa": cfg.window,
              "attn_local": cfg.local_window}.get(kind, 0)
    h, new_cache = attention_block(
        p["attn"], _norm(cfg, p["norm1"], x), cfg, positions=positions,
        cache=cache, causal=causal and kind != "enc_attn", window=window)
    return h, new_cache


def _ffn_half(cfg, kind, p, x):
    """The FFN sub-layer (dense, or MoE) with its residual."""
    ff_in = _norm(cfg, p["norm2"], x)
    if kind == "moe":
        with sub_span("step.prefill.moe"):
            if cfg.moe_impl == "shard_map":
                return _residual(cfg, x, moe_block_ep(p["moe"], ff_in, cfg))
            return _residual(cfg, x, moe_block(p["moe"], ff_in, cfg))
    return _residual(cfg, x, L.mlp_swiglu(p["mlp"], ff_in))


def _superblock(cfg, slot_params, x, *, positions, caches=None,
                cache_len=None, cache_bt=None, cross_states=None,
                split_remat=False, lengths=None):
    """Apply one instance of the block pattern.  slot_params/caches are
    per-slot lists (already sliced to this super-block)."""
    new_caches = []
    for slot, kind in enumerate(cfg.block_pattern):
        c = caches[slot] if caches is not None else None
        x, nc = block_forward(cfg, kind, slot_params[slot], x,
                              positions=positions, cache=c,
                              cache_len=cache_len, cache_bt=cache_bt,
                              cross_states=cross_states,
                              split_remat=split_remat, lengths=lengths)
        new_caches.append(nc)
    return x, new_caches


# matmul outputs the "dots" policy keeps (matmul and einsum reach these)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, body, policy=None):
    """``body`` rematerialized per ``policy`` (default
    ``cfg.remat_policy``) while autograd records (serving and eval run it
    as it is)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body
    policy = policy or cfg.remat_policy
    if policy == "full":
        context_fn = ckpt.noop_context_fn
    elif policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif policy == "attn_out":
        # checkpoint regions per block inside the body (block_forward)
        return functools.partial(body, split_remat=True)
    else:
        raise ValueError(f"unknown remat policy {policy!r}")

    def run(*args, **kwargs):
        return ckpt.checkpoint(body, *args, use_reentrant=False,
                               context_fn=context_fn, **kwargs)
    return run


def _restack(base, *zs):
    """The super-blocks' caches of one leaf stacked again under
    attention.cache_in_place: ``base`` itself when every block wrote its
    slice of ``base`` in place, else a new stacked tensor."""
    if all(z.data_ptr() == base[i].data_ptr() and z.shape == base[i].shape
           and z.stride() == base[i].stride() for i, z in enumerate(zs)):
        return base
    return torch.stack(zs)


def run_stack(cfg, params, x, *, positions, caches=None, cross_states=None,
              lengths=None):
    """Loop over super-blocks (+ extra blocks).  Returns (x, new_caches);
    per-layer cache outputs are re-stacked along the leading axis.
    ``lengths``: each row's prompt length in a padded SSD prefill."""
    kw = {} if lengths is None else {"lengths": lengths}
    x = constrain(x, "batch", None, None)
    cache_len = caches["len"] if caches is not None else None
    cache_bt = caches.get("bt") if caches is not None else None
    scanned = (caches["layers"] if caches is not None
               else [None] * len(cfg.block_pattern))
    body = _remat(cfg, _superblock)
    ys = []
    for i in range(cfg.n_pattern_blocks):
        slot_params, slot_caches = tree_map(lambda a: a[i],
                                            (params["blocks"], scanned))
        x, y = body(cfg, slot_params, x, positions=positions,
                    caches=slot_caches, cache_len=cache_len,
                    cache_bt=cache_bt, cross_states=cross_states, **kw)
        ys.append(y)
    if caches is None:
        new_layer_caches = None
    elif cache_in_place_enabled():
        new_layer_caches = tree_map(_restack, scanned, *ys)
    else:
        new_layer_caches = tree_map(lambda *zs: torch.stack(zs), *ys)

    new_extra = []
    for i, kind in enumerate(cfg.extra_blocks):
        c = caches["extra"][i] if caches is not None else None
        x, nc = block_forward(cfg, kind, params["extra"][i], x,
                              positions=positions, cache=c,
                              cache_len=cache_len, cache_bt=cache_bt,
                              cross_states=cross_states, **kw)
        new_extra.append(nc)

    new_caches = None
    if caches is not None:
        new_caches = {"layers": new_layer_caches, "extra": new_extra,
                      "len": cache_len + x.shape[1]}
    return x, new_caches


def _encoder_layer(cfg, p, x, *, positions):
    return block_forward(cfg, "enc_attn", p, x, positions=positions,
                         causal=False)[0]


def encode(cfg: ModelConfig, params, frontend_embeds):
    """Encoder stack (Whisper): frontend embeddings [B, T, d] -> states
    [B, T, d] in ``cfg.dtype``."""
    x = frontend_embeds.to(getattr(torch, cfg.dtype))
    x = x + params["enc_pos"][:x.shape[1]][None]
    positions = torch.arange(x.shape[1], device=x.device)[None]
    body = _remat(cfg, _encoder_layer, "full")
    for i in range(cfg.enc_layers):
        p = tree_map(lambda a: a[i], params["encoder"])
        x = body(cfg, p, x, positions=positions)
    return _norm(cfg, params["enc_final_norm"], x)


def forward(cfg: ModelConfig, params, tokens, *, cross_states=None,
            frontend_embeds=None):
    """Eval forward: tokens [B, S] -> logits [B, S, vocab].

    The VLM passes its vision states as ``cross_states``; Whisper's
    ``frontend_embeds`` [B, T, d] are encoded first (:func:`encode`)."""
    if cfg.enc_layers and frontend_embeds is not None:
        cross_states = encode(cfg, params, frontend_embeds)
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None]
    x, _ = run_stack(cfg, params, x, positions=positions,
                     cross_states=cross_states)
    x = _norm(cfg, params["final_norm"], x)
    return constrain(head_logits(cfg, params, x), "batch", None, "vocab")


def embed_tokens(cfg: ModelConfig, params, tokens):
    """Token embeddings in ``cfg.dtype``, times the config's
    ``embedding_multiplier``."""
    x = L.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def head_logits(cfg: ModelConfig, params, x):
    """The output head (tied or not) over ``x``, divided by the config's
    ``logits_scaling``."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    y = L.unembed(x, head)
    if cfg.logits_scaling != 1.0:
        y = y / cfg.logits_scaling
    return y
