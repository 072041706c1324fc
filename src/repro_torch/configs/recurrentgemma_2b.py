"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427].  26 layers = 8 x (rglru, rglru, attn_local) + 2 rglru.
Recurrent state is O(1)/token, so the 500k-decode cell RUNS."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    rope_theta=10000.0,
    block_pattern=("rglru", "rglru", "attn_local"),
    extra_blocks=("rglru", "rglru"),
    local_window=2048, rglru_width=2560, conv_kernel=4,
    tie_embeddings=True,
)
