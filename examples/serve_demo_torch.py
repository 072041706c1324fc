"""Batched serving demo on the PyTorch port: prefill + lock-step decode
with a KV cache, through ServingEngine.run_batch — one batch of
same-length prompts, decoded in lock-step and drained to its slowest
request.  For true continuous batching (mid-decode admission, slot-pooled
cache, mixed-length prompts) see serve/scheduler/.

    PYTHONPATH=src python examples/serve_demo_torch.py --arch llama3-8b
    PYTHONPATH=src python examples/serve_demo_torch.py \\
        --arch deepseek-moe-16b --device cpu
(the arch's reduced smoke config is served, with random weights from a
seed; ``--device`` defaults to the CUDA card.  ``--arch
llama-3.2-vision-90b`` passes seeded vision states as ``cross_states``;
``--arch whisper-small`` seeded frame embeddings as ``frontend_embeds``,
which the engine encodes once for the batch.)
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    engine = ServingEngine(cfg, params, max_len=args.prompt_len
                           + args.max_new + 8, device=dev)

    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab, args.prompt_len)
                    .astype(np.int32), max_new_tokens=args.max_new)
            for _ in range(args.batch)]

    extras = {}
    if cfg.family == "vlm":
        extras["cross_states"] = torch.from_numpy(
            rng.randn(args.batch, cfg.frontend_tokens, cfg.d_model)
            .astype(np.float32)).to(dev, getattr(torch, cfg.dtype))
    elif cfg.enc_layers:
        extras["frontend_embeds"] = rng.randn(
            args.batch, cfg.frontend_tokens, cfg.d_model).astype(np.float32)

    t0 = time.perf_counter()
    out = engine.run_batch(reqs, **extras)
    dt = time.perf_counter() - t0

    total_new = sum(len(r.out_tokens) for r in out)
    print(f"arch={cfg.name}  device={dev}  batch={args.batch}  "
          f"prompt={args.prompt_len}  generated={total_new} tokens "
          f"in {dt:.2f}s  ({total_new / dt:.1f} tok/s)")
    print(f"stats: {engine.stats}")
    if engine.terra is not None:
        coexec = {k: v for k, v in engine.terra.stats.items()
                  if isinstance(v, int)}
        print(f"decode phase: {engine.terra.phase}  coexec stats: {coexec}")
    print(f"first sequence: {out[0].out_tokens[:16]}")
    engine.close()


if __name__ == "__main__":
    main()
