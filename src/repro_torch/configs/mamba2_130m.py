"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].
Attention-free; the 500k-decode cell RUNS (recurrent state, O(1)/token)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    block_pattern=("ssd",),
    ssm_heads=24, ssm_head_dim=64, ssm_state=128,   # d_inner = 2*d_model
    conv_kernel=4, ssd_chunk=256, tie_embeddings=True,
    head_dim=1,
)
