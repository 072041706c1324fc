"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].

Sliding-window attention bounds the KV working set, so the 500k-decode
shape cell RUNS for this arch (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128,
    rope_theta=1000000.0, block_pattern=("moe",),
    n_experts=8, top_k=2, window=4096,
)
