"""Training launcher: config-driven entry point wiring the process group,
the mesh, the sharding policy, the Terra-driven Trainer, checkpointing and
elastic restart.

    # one process on the CUDA card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 50 --batch 8 --seq-len 2048 --ckpt-dir /tmp/ckpt

    # one process on the CPU (asked for explicitly):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --steps 20 --device cpu --ckpt-dir /tmp/ckpt

    # elastic: torchrun starts one process per card (or CPU process with
    # --device cpu, over gloo); the launcher builds a (data, model) mesh
    # from the world size and --model-parallel, and reshards the
    # checkpoint on load
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch granite-3-2b --smoke --steps 100 --model-parallel 2

When torchrun's variables are set (``RANK``, ``WORLD_SIZE``) the launcher
calls ``init_process_group`` itself: ``nccl`` on the card, ``gloo`` on
the CPU, with ``MASTER_ADDR``/``MASTER_PORT`` (or ``--init-method``).
Fault tolerance: crash at any point and re-launch with the same
``--ckpt-dir`` — training resumes from the last committed step with the
data stream reseeked deterministically, on however many processes the new
launch has.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer


def init_distributed(device: torch.device, init_method=None) -> int:
    """Join the process group torchrun describes (``RANK``,
    ``WORLD_SIZE``); returns the world size (1 without torchrun)."""
    import torch.distributed as dist
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 1
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world)
    return world


def build_mesh(model_parallel: int, world: int, device: torch.device):
    if world == 1 or model_parallel <= 1:
        return None
    assert world % model_parallel == 0, \
        f"{world} processes not divisible by model_parallel={model_parallel}"
    return make_mesh_for({"data": world // model_parallel,
                          "model": model_parallel}, device.type)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--total-steps", type=int, default=None,
                    help="the LR schedule's length (default: --steps); a "
                         "resumed run given the first run's value "
                         "continues its schedule")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--no-terra", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a multiple "
                         "of the block pattern; width stays published)")
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="compute and parameter dtype (default: the "
                         "config's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU runs only when "
                         "asked for")
    ap.add_argument("--init-method", default=None,
                    help="init_process_group's init_method under torchrun "
                         "(default: env://)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    world = init_distributed(device, args.init_method)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype,
                                  param_dtype=args.dtype)
    mesh = build_mesh(args.model_parallel, world, device)
    print(f"launch: arch={cfg.name} devices={world} "
          f"mesh={'1-device' if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")

    total = args.total_steps or args.steps
    trainer = Trainer(
        cfg,
        OptConfig(lr=args.lr, warmup_steps=max(total // 20, 2),
                  total_steps=total),
        ckpt_dir=args.ckpt_dir, batch=args.batch, seq_len=args.seq_len,
        microbatches=args.microbatches, mesh=mesh,
        log_every=args.log_every, ckpt_every=args.ckpt_every,
        use_terra=not args.no_terra, seed=args.seed, device=device)
    if trainer.start_step:
        print(f"auto-resumed from step {trainer.start_step}")
    hist = trainer.train(args.steps)
    if hist:
        print(f"done: loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}")
    if trainer.straggler_events:
        print(f"stragglers flagged: {len(trainer.straggler_events)}")
    if not args.no_terra:
        print("terra:", {k: v for k, v in trainer._iteration.stats.items()
                         if isinstance(v, int)})
        trainer._iteration.close()
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
