"""Continuous-batching serving demo on the PyTorch port: mixed-length
prompts, Poisson arrivals, mid-decode admission and per-token streaming —
the serving main loop running as an imperative program under Terra
co-execution (serve/scheduler/, DESIGN.md §11).

    PYTHONPATH=src python examples/serve_continuous_torch.py --arch llama3-8b
    PYTHONPATH=src python examples/serve_continuous_torch.py --device cpu
(the arch's reduced smoke config is served, with random weights from
``--seed``; ``--device`` defaults to the CUDA card, and without one the
program raises unless ``--device cpu`` is given.)
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import Request
from repro_torch.serve.scheduler import ContinuousBatchingScheduler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--mean-gap-ms", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                           device=dev)
    sch = ContinuousBatchingScheduler(cfg, params,
                                      max_slots=args.max_slots,
                                      max_len=args.max_len, device=dev)

    rng = np.random.RandomState(args.seed)
    streamed = []
    t0 = time.perf_counter()
    offsets = np.cumsum(rng.exponential(args.mean_gap_ms / 1e3,
                                        args.requests))
    reqs = []
    for i in range(args.requests):
        L = int(rng.choice([8, 16, 32]))
        reqs.append(Request(
            prompt=rng.randint(0, cfg.vocab, L).astype(np.int32),
            max_new_tokens=int(rng.randint(4, 33)),
            arrival_time=t0 + float(offsets[i]),
            stream=lambda r, tok, idx: streamed.append((tok, idx))))
    sch.serve(reqs)
    wall = time.perf_counter() - t0

    total = sum(len(r.out_tokens) for r in reqs)
    ttft = [r.first_token_time - r.arrival_time for r in reqs]
    print(f"arch={cfg.name}  requests={args.requests}  "
          f"slots={args.max_slots}  generated={total} tokens in "
          f"{wall:.2f}s  ({total / wall:.1f} tok/s)  "
          f"ttft_p50={np.percentile(ttft, 50) * 1e3:.1f}ms")
    st = sch.stats
    print(f"sched: admitted={st['admitted']} retired={st['retired']} "
          f"decode_steps={st['decode_steps']} "
          f"prefill_steps={st['prefill_steps']} "
          f"streamed={len(streamed)}")
    print(f"coexec: phase={st['phase']} retraces={st['retraces']} "
          f"families={st['families']} replays={st['replays']} "
          f"walker_fast_hits={st['walker_fast_hits']}")
    print(f"first sequence: {reqs[0].out_tokens[:16]}")
    sch.close()


if __name__ == "__main__":
    main()
