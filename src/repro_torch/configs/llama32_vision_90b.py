"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-90B-Vision].  The vision tower is a STUB per the
brief: input_specs() provides precomputed patch embeddings [B, 1600, d]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    rope_theta=500000.0,
    block_pattern=("attn", "attn", "attn", "attn", "cross"),
    frontend_tokens=1600,
)
