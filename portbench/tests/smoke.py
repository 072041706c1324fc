"""Tiny versions of the benchmark's cells for the CPU tests: the cell's
own files, with the model's widths and depth and the traffic's sizes cut
so that a whole run takes seconds on a CPU."""

from __future__ import annotations

import time

from portbench.core import env, manifest, runner

env.prepare()

TRAIN = "mamba2-130m.train-16x2048"
SERVE = "deepseek-moe-16b.chat"


def train_cell(name: str = TRAIN, man=None, traffic_dir=None):
    cell = manifest.cell(name, man=man, traffic_dir=traffic_dir)
    cell.config["model"].update(n_layers=2, d_model=64, ssm_heads=4,
                                ssm_head_dim=16, ssm_state=16, ssd_chunk=16,
                                vocab=512, remat=False)
    cell.traffic.update(batch=4, seq_len=64, setup_steps=4)
    return cell


def serve_cell(name: str = SERVE, man=None, traffic_dir=None):
    cell = manifest.cell(name, man=man, traffic_dir=traffic_dir)
    cell.config["model"].update(n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=4, head_dim=16, d_ff=32,
                                moe_d_ff=32, vocab=512, n_experts=8,
                                top_k=2, n_shared_experts=1,
                                capacity_factor=8.0)
    mix = cell.traffic
    mix["rate"] = 8.0
    mix["scheduler"].update(max_slots=4, max_len=128, prefill_batch_cap=2)
    mix["prompt"].update(median=16, min=8, max=64)
    mix["output"].update(min=4, max=24)
    mix["sample_tokens"] = 40
    return cell


def run(cell, seed: int = 3, seconds: float = 1.0):
    """One run of ``cell`` on the CPU: (spec, outcome)."""
    spec = runner.Spec(cell=cell, seed=seed, seconds=seconds, trace=False,
                       device="cpu", t0=time.perf_counter())
    return spec, manifest.driver(cell.traffic["driver"]).run(spec)
