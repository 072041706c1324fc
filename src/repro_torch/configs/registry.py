"""Architecture registry + reduced smoke-test variants.

``get_config(arch_id)`` returns the exact published configuration;
``smoke_config(arch_id)`` returns a reduced config of the same family
(small width, few layers/experts, tiny vocab) for CPU smoke tests — the
full configs are exercised only through the dry-run (ShapeDtypeStruct, no
allocation)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (codeqwen15_7b, deepseek_moe_16b,
                                 granite3_2b, llama3_8b, llama32_vision_90b,
                                 mamba2_130m, mixtral_8x22b, qwen25_14b,
                                 recurrentgemma_2b, whisper_small)
from repro_torch.configs.base import ModelConfig

ARCHS = {
    "llama3-8b": llama3_8b.CONFIG,
    "codeqwen1.5-7b": codeqwen15_7b.CONFIG,
    "qwen2.5-14b": qwen25_14b.CONFIG,
    "granite-3-2b": granite3_2b.CONFIG,
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "deepseek-moe-16b": deepseek_moe_16b.CONFIG,
    "mamba2-130m": mamba2_130m.CONFIG,
    "llama-3.2-vision-90b": llama32_vision_90b.CONFIG,
    "whisper-small": whisper_small.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
}

# archs with a sub-quadratic long-context path: long_500k runs for these
LONG_CONTEXT_ARCHS = {"mixtral-8x22b", "mamba2-130m", "recurrentgemma-2b"}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[arch]
    cfg.validate()
    return cfg


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: one or two super-blocks, small dims."""
    cfg = get_config(arch)
    per = len(cfg.block_pattern)
    repl = dict(
        name=cfg.name + "-smoke",
        n_layers=per + len(cfg.extra_blocks),
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 1,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        q_block=32, kv_block=32,
        remat=False,
    )
    if cfg.n_experts:
        # capacity_factor = E guarantees zero token drops, so the smoke
        # prefill/decode consistency check is exact (capacity dropping is a
        # train-time approximation, not a correctness bug)
        repl.update(n_experts=4, top_k=2,
                    moe_d_ff=64 if cfg.moe_d_ff else 0,
                    n_shared_experts=min(cfg.n_shared_experts, 1),
                    capacity_factor=4.0)
    if cfg.ssm_heads:
        repl.update(ssm_heads=4, ssm_head_dim=16, ssm_state=16, ssd_chunk=16)
    if cfg.rglru_width:
        repl.update(rglru_width=64)
    if cfg.enc_layers:
        repl.update(enc_layers=1)
    if cfg.frontend_tokens:
        repl.update(frontend_tokens=24)
    if cfg.window:
        repl.update(window=16)
    if cfg.local_window:
        repl.update(local_window=16)
    out = dataclasses.replace(cfg, **repl)
    out.validate()
    return out
