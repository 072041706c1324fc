"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066].  (The published model uses one dense first layer; we use
the MoE pattern uniformly — noted in DESIGN.md.)"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, head_dim=128,
    rope_theta=10000.0, block_pattern=("moe",),
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
)
