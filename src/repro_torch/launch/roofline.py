"""Roofline terms from the dry run's counts.

Three terms per (arch x shape x mesh), all in seconds (per step, per card):

    compute    = FLOPs / PEAK_FLOPS_BF16
    memory     = bytes_accessed / HBM_BW
    collective = wire_bytes / NVLINK_BW

The numbers are analytic: the FLOPs, bytes and collectives are counted
by the dry run (``launch/dryrun.py``) on ``meta`` tensors, and the rates
are the NVIDIA H100 SXM5 data sheet's constants (``launch/mesh.py``), not
measured.  The collective log holds every collective the program issues
on one card, as (kind, operand shape, dtype); its bytes are weighted by
the ring wire-cost factor of the kind (all-reduce moves ~2x its operand
bytes on a ring; gather/scatter/a2a ~1x; permute 1x).  The operand is
what an HLO collective's operand is: the local shard for an all-gather,
the full input for an all-reduce and a reduce-scatter.

Every collective is charged at one card's NVLink rate.  The production
mesh's 16-wide ``model`` axis spans two 8-card NVLink domains, so part of
its traffic crosses the slower inter-node network: the collective term is
a lower bound, and no other bandwidth is added.

The dry run also reports MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D
(MoE) and the useful-compute ratio; when the ratio is far from ~1 the
analytic number is the one to trust for absolute times."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

_WIRE_FACTOR = {
    "all-gather": 1.0,        # each card receives (N-1)/N of the result
    "all-reduce": 2.0,        # ring: reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "int64": 8, "uint64": 8,
    "int32": 4, "uint32": 4, "int16": 2, "uint16": 2, "int8": 1,
    "uint8": 1, "bool": 1, "complex64": 8, "complex128": 16,
}


def _shape_bytes(shape: Tuple[int, ...], dtype: str) -> int:
    return math.prod(shape) * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(log: Iterable[Tuple[str, Tuple[int, ...], str]]
                     ) -> Dict[str, float]:
    """Sum wire bytes per collective kind from the collective log:
    (kind, operand shape, dtype name) per collective as issued."""
    out: Dict[str, float] = {k: 0.0 for k in _WIRE_FACTOR}
    count = 0
    for kind, shape, dtype in log:
        out[kind] += _shape_bytes(tuple(shape), dtype) * _WIRE_FACTOR[kind]
        count += 1
    out["n_collectives"] = count
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    wire_bytes: float            # per device
    compute_s: float
    memory_s: float
    collective_s: float
    per_coll: Dict[str, float]
    model_flops_per_device: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> Optional[float]:
        if self.model_flops_per_device and self.flops:
            return self.model_flops_per_device / self.flops
        return None

    def as_dict(self):
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["useful_ratio"] = self.useful_ratio
        return d


def analyze(counts, *, model_flops_total: float = 0.0,
            n_chips: int = 1) -> Roofline:
    """The roofline of one dry-run count record (``dryrun.Counts``)."""
    coll = collective_bytes(counts.collectives)
    wire = sum(v for k, v in coll.items() if k != "n_collectives")
    return Roofline(
        flops=float(counts.flops),
        bytes_accessed=float(counts.bytes_accessed),
        wire_bytes=wire,
        compute_s=counts.flops / PEAK_FLOPS_BF16,
        memory_s=counts.bytes_accessed / HBM_BW,
        collective_s=wire / NVLINK_BW,
        per_coll=coll,
        model_flops_per_device=model_flops_total / max(n_chips, 1),
    )


def analytic_memory_bytes(cfg, shape, n_chips: int,
                          microbatches: int = 1) -> Dict[str, float]:
    """Analytic per-card HBM traffic model (the honest memory term).

    Counting every operand of every unfused op is a gross upper bound
    that has little to do with HBM traffic after fusion.  This model
    instead counts the structurally unavoidable traffic, assuming
    attention/SSD internals stay on chip.  This is the reference's model,
    kept line for line.  The port's serve paths meet that assumption
    through its fused kernels; its training path does not: a
    differentiated graph is left unfused and the SSD backward is plain
    math (PERF.md §5: the plain SSD backward dominates the mamba2 step),
    so the train term is below the traffic the port really moves.

      train:   params re-read per microbatch x3 (fwd, bwd, remat recompute)
               + optimizer state r/w (34 B/param: bf16 params w, f32
               master/m/v r+w, f32 grads r+w)
               + activation checkpoints w+r (scan carry per super-block)
               + KV streamed per attention query block
      prefill: params read once + cache written + KV re-read per q block
      decode:  params read once + full cache read + one-token cache write
    """
    from repro_torch.models import model as M

    n_params = M.param_count(cfg)
    n_active = M.active_param_count(cfg)
    p_bytes = 2.0 * n_params / n_chips                 # bf16 shard per card
    a_bytes = 2.0 * n_active / n_chips
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    bf = 2.0
    # data-parallel degree: batch shards over (pod, data) = n_chips / 16
    dp = max(n_chips // 16, 1)
    b_loc = max(B // dp, 1)

    n_super = cfg.n_pattern_blocks
    attn_layers = sum(cfg.block_pattern.count(k)
                      for k in ("attn", "attn_swa", "attn_local", "moe",
                                "dec_attn_cross")) * n_super
    kvh, hd = max(cfg.n_kv_heads, 1), cfg.head_dim

    if shape.kind == "train":
        mb = max(microbatches, 1)
        opt = 34.0 * n_params / n_chips
        # active params re-read per microbatch: fwd + bwd + remat recompute
        param_traffic = 3.0 * mb * a_bytes
        # activation checkpoints: one carry per super-block, written + read
        carry = (b_loc / mb) * S * d * bf
        act = 2.0 * carry * n_super * mb
        # flash attention: KV streamed once per query block (kv heads are
        # below the model-axis width -> replicated, full kv per card)
        nq = max(S // cfg.q_block, 1)
        kv_bytes = (b_loc / mb) * S * kvh * hd * 2 * bf
        attn = attn_layers * nq * kv_bytes * mb * 3           # fwd+bwd+remat
        total = opt + param_traffic + act + attn
        return {"total": total, "opt": opt, "params": param_traffic,
                "activations": act, "attention_kv": attn}
    if shape.kind == "prefill":
        nq = max(S // cfg.q_block, 1)
        kv_total = attn_layers * B * S * kvh * hd * 2 * bf / n_chips
        attn = nq * kv_total
        act = B * S * d * bf * n_super / n_chips
        total = p_bytes + kv_total + attn + act
        return {"total": total, "params": p_bytes, "cache_write": kv_total,
                "attention_kv": attn, "activations": act}
    # decode: one token
    cache_read = attn_layers * B * S * kvh * hd * 2 * bf / n_chips
    state = 0.0
    if cfg.ssm_heads:
        state = (cfg.n_layers * B * cfg.ssm_heads * cfg.ssm_head_dim
                 * cfg.ssm_state * 4.0 * 2) / n_chips
    if cfg.rglru_width:
        state += (cfg.n_layers * B * cfg.rglru_width * 4.0 * 2) / n_chips
    if cfg.window:
        cache_read = attn_layers * B * min(S, cfg.window) * kvh * hd * 2 \
            * bf / n_chips
    if cfg.local_window:
        cache_read = attn_layers * B * min(S, cfg.local_window) * kvh * hd \
            * 2 * bf / n_chips
    total = p_bytes + cache_read + state
    return {"total": total, "params": p_bytes, "cache_read": cache_read,
            "state": state}


def memory_report(counts) -> Dict[str, float]:
    """The reference's memory keys from one dry-run count record: the
    arguments' and the outputs' live bytes on one card, the temporaries
    (the peak of live bytes less the arguments and the outputs: what
    lives only inside the step) and the outputs that alias donated
    arguments (the decode cache)."""
    out = {"argument_size_in_bytes": int(counts.argument_bytes),
           "output_size_in_bytes": int(counts.output_bytes),
           "temp_size_in_bytes": int(counts.temp_bytes),
           "alias_size_in_bytes": int(counts.alias_bytes)}
    out["total_nonalias_bytes"] = (out["argument_size_in_bytes"]
                                   + out["output_size_in_bytes"]
                                   + out["temp_size_in_bytes"]
                                   - out["alias_size_in_bytes"])
    return out
