"""whisper-small [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

n_layers counts the DECODER layers; enc_layers the encoder.  The conv
frontend is a stub: input_specs() provides precomputed frame embeddings
[B, 1500, d].  Decoder uses RoPE instead of learned positions (deviation
noted in DESIGN.md); assigned 32k shapes stress the architecture beyond its
trained 448 positions but are structurally well-defined.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64, norm="ln",
    rope_theta=10000.0,
    block_pattern=("dec_attn_cross",),
    enc_layers=12, frontend_tokens=1500,
)
