"""Perf hillclimb: run the chosen (arch x shape) cells of the dry
run with candidate optimizations and record hypothesis -> before -> after.

Cells (the reference's selection from its roofline table):
  A. llama3-8b x train_4k       — representative; collective-bound baseline
  B. llama3-8b x prefill_32k    — most collective-bound serve cell
  C. qwen2.5-14b x train_4k     — worst roofline fraction (40 heads do not
                                   divide the 16-way model axis -> attention
                                   compute replicates)

Run:
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --out hc.json

The numbers are the dry run's (``launch/dryrun.py``): analytic, counted
on ``meta`` tensors against the H100 data sheet's rates, not measured.
"""

import argparse
import json

from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import PEAK_FLOPS_BF16

EXPERIMENTS = [
    # (cell-id, arch, shape, variant-name, opts, hypothesis)
    ("A", "llama3-8b", "train_4k", "baseline", {},
     "baseline: FSDP all-gather repeats per microbatch (8x)"),
    ("A", "llama3-8b", "train_4k", "mb4", {"microbatches": 4},
     "halving microbatches halves per-step param all-gather wire bytes; "
     "activation memory doubles but still fits"),
    ("A", "llama3-8b", "train_4k", "mb4+dots",
     {"microbatches": 4, "remat_policy": "dots"},
     "saving matmul outputs (dots policy) removes most remat recompute: "
     "compute term -> ~model_flops; memory grows by saved dots"),
    ("A", "llama3-8b", "train_4k", "mb2+dots",
     {"microbatches": 2, "remat_policy": "dots"},
     "quartering the all-gather again if memory still fits"),

    ("B", "llama3-8b", "prefill_32k", "baseline", {},
     "baseline: FSDP-sharded params are all-gathered per layer at "
     "inference"),
    ("B", "llama3-8b", "prefill_32k", "pure-tp", {"serve_fsdp": False},
     "inference params need no FSDP: shard over model axis only -> "
     "per-layer weight all-gather disappears (the bf16 weights over the "
     "16-way model axis fit)"),

    ("C", "qwen2.5-14b", "train_4k", "baseline", {},
     "baseline: 40 heads % 16-way model axis != 0 -> attention activations "
     "replicate across the model axis (compute bloat)"),
    ("C", "qwen2.5-14b", "train_4k", "mesh32x8", {"mesh_shape": (32, 8)},
     "re-factor the 256-card pod as (data=32, model=8): 40 heads, 8 kv "
     "heads, d_ff 13824 and vocab 152064 all divide 8 -> attention shards; "
     "DP width doubles (batch 256/32=8 per replica still >= 1)"),
    ("C", "qwen2.5-14b", "train_4k", "mesh32x8+dots",
     {"mesh_shape": (32, 8), "remat_policy": "dots"},
     "stack the remat win on top of the mesh fix"),
]

# round 2 (after analyzing round-1 per-collective breakdowns): the shared
# residual bottleneck is the TP activation all-reduce (~ tokens x d_model /
# device) plus a logits all-gather on the vocab-sharded axis.
ROUND2 = [
    ("A", "llama3-8b", "train_4k", "onehot-loss", {"microbatches": 4},
     "one-hot label contraction removes the vocab-axis logits all-gather"),
    ("A", "llama3-8b", "train_4k", "mesh32x8+mb4",
     {"microbatches": 4, "mesh_shape": (32, 8)},
     "data=32/model=8 halves per-device tokens -> TP activation all-reduce "
     "halves; weight all-gather grows (shards are 2x bigger) but nets out"),
    ("B", "llama3-8b", "prefill_32k", "mesh32x8+pure-tp",
     {"serve_fsdp": False, "mesh_shape": (32, 8)},
     "prefill collective is TP activation all-reduce: "
     "data=32 halves per-device tokens -> AR halves"),
    ("B", "llama3-8b", "prefill_32k", "mesh32x8-fsdp",
     {"mesh_shape": (32, 8)},
     "same mesh refactor with FSDP params kept (ablation)"),
    ("C", "qwen2.5-14b", "train_4k", "mesh64x4",
     {"mesh_shape": (64, 4), "microbatches": 8},
     "push further: model=4 still divides heads(40)/kv(8)/d_ff/vocab; "
     "TP activation AR drops another 2x; weight shards grow 2x"),
]
EXPERIMENTS = EXPERIMENTS + ROUND2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="hillclimb.json")
    ap.add_argument("--cell", default=None, choices=[None, "A", "B", "C"])
    args = ap.parse_args()
    results = []
    for cell, arch, shape, variant, opts, hyp in EXPERIMENTS:
        if args.cell and cell != args.cell:
            continue
        print(f"--- {cell}/{variant}: {hyp[:70]}...", flush=True)
        rec = run_cell(arch, shape, "single", opts=opts)
        rec.update(cell=cell, variant=variant, hypothesis=hyp)
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        if rec["status"] == "ok" and "roofline" in rec:
            r = rec["roofline"]
            est = max(r["compute_s"], r["memory_s"], r["collective_s"])
            ideal = r["model_flops_per_device"] / PEAK_FLOPS_BF16
            print(f"    compute {r['compute_s']:.3f}s  "
                  f"mem {r['memory_s']:.3f}s  coll {r['collective_s']:.3f}s "
                  f"-> frac {100 * ideal / est:.1f}% "
                  f"(fits={rec['fits_hbm']}, "
                  f"HBM {rec['memory']['total_nonalias_bytes'] / 2**30:.1f}"
                  f"GiB)", flush=True)


if __name__ == "__main__":
    main()
