"""Model / run configuration schema.

Every assigned architecture is expressed as a ModelConfig with a
``block_pattern``: the repeating sequence of block kinds scanned over by the
transformer assembly (models/transformer.py).  Kinds:

    attn            global causal self-attention + SwiGLU MLP
    attn_swa        sliding-window self-attention + MLP (Mixtral)
    attn_local      local self-attention + MLP (RecurrentGemma, window)
    moe             self-attention + MoE FFN
    ssd             Mamba-2 SSD block (attention-free, no separate MLP)
    ssd_moe         Mamba-2 mixer + MoE FFN (granite-4.0-h's mamba layers)
    rglru           RG-LRU recurrent block + MLP
    cross           cross-attention (vision/encoder states) + MLP
    enc_attn        bidirectional self-attention + MLP (encoders)
    dec_attn_cross  decoder self-attn + cross-attn + MLP (Whisper decoder)

The schema is the reference's field for field, plus the port-only fields
of :data:`PORT_ONLY` (the granite-4.0-h hybrid's departures from the
llama-family block), each of which defaults to the behaviour every
reference config has; so a port config's :func:`reference_view` compares
equal to its reference counterpart.  Field comments give the reference's
meaning.  The port reads every field (remat policies "full", "dots" and
"attn_out"; ``moe_impl`` "shard_map" is ``models/moe_ep.py``) but
``unroll``, which has no effect: the port runs its loops in Python.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|vlm|audio|hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm: str = "rms"                 # rms | ln
    tie_embeddings: bool = False

    # block pattern
    block_pattern: Tuple[str, ...] = ("attn",)
    extra_blocks: Tuple[str, ...] = ()   # appended after the scanned stack
    window: int = 0                    # SWA window for attn_swa
    local_window: int = 0              # window for attn_local

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                  # per-expert hidden (fine-grained MoE)
    capacity_factor: float = 1.25
    # "pjit": capacity-scatter dispatch partitioned by XLA SPMD (simple but
    # partitioner-limited, see EXPERIMENTS.md §Roofline); "shard_map":
    # explicit local-dispatch + all_to_all expert parallelism (requires
    # n_experts % model-axis == 0)
    moe_impl: str = "pjit"

    # SSM (Mamba-2)
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_state: int = 0
    conv_kernel: int = 4
    ssd_chunk: int = 256

    # RG-LRU
    rglru_width: int = 0

    # encoder-decoder (Whisper): n_layers = decoder layers
    enc_layers: int = 0

    # modality frontend stub (audio frames / vision patches): number of
    # frontend embedding tokens fed by input_specs()
    frontend_tokens: int = 0

    # compute
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    q_block: int = 512
    kv_block: int = 1024
    remat: bool = True
    # remat policy: "full" rematerializes everything; "dots" saves matmul
    # outputs (jax dots_saveable) trading HBM for ~25% less recompute
    remat_policy: str = "full"
    # unroll every lax.scan (layers, attention blocks, SSD chunks).  Used by
    # the dry-run cost probes: XLA cost_analysis counts a while-loop body
    # ONCE regardless of trip count, so loops must be unrolled for honest
    # FLOP/byte/collective accounting (launch/dryrun.py).
    unroll: bool = False

    # port-only fields (PORT_ONLY), each at the reference's behaviour by
    # default: granite-4.0-h's NoPE attention with its own softmax scale
    # (0 -> head_dim^-1/2), its multipliers on the embedding, on each
    # residual branch and (dividing) on the logits, the norms' epsilon,
    # and the Mamba-2 mixer's D skip, gated RMSNorm before the out
    # projection and conv bias
    nope: bool = False
    attn_scale: float = 0.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    norm_eps: float = 1e-6
    ssm_d_skip: bool = False
    ssm_gated_norm: bool = False
    conv_bias: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def n_pattern_blocks(self) -> int:
        per = len(self.block_pattern)
        return (self.n_layers - len(self.extra_blocks)) // per

    def validate(self):
        per = len(self.block_pattern)
        assert (self.n_layers - len(self.extra_blocks)) % per == 0, \
            f"{self.name}: {self.n_layers} layers not divisible by " \
            f"pattern {self.block_pattern} + extras {self.extra_blocks}"


PORT_ONLY = ("nope", "attn_scale", "embedding_multiplier",
             "residual_multiplier", "logits_scaling", "norm_eps",
             "ssm_d_skip", "ssm_gated_norm", "conv_bias")


def reference_view(cfg: ModelConfig) -> dict:
    """``dataclasses.asdict(cfg)`` in the reference's schema: without the
    port-only fields, after checking that each is at its default (a config
    that sets one has no reference counterpart: ValueError)."""
    d = dataclasses.asdict(cfg)
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    off = [k for k in PORT_ONLY if d[k] != defaults[k]]
    if off:
        raise ValueError(f"{cfg.name}: port-only fields {off} are set; the "
                         "reference's schema cannot express them")
    return {k: v for k, v in d.items() if k not in PORT_ONLY}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# smoke-test shapes (reduced, CPU-friendly)
SMOKE_SHAPE = ShapeConfig("smoke", "train", 64, 2)
