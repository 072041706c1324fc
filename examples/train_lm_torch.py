"""End-to-end driver on the PyTorch port: train a language model through
the full framework stack — synthetic data pipeline, AdamW, remat
transformer, Terra co-execution, checkpointing with auto-resume, straggler
watchdog — on the CUDA card (``--device cpu`` asks for the CPU).

    # ~130M-parameter model, a few hundred steps (one H100):
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300

    # CPU-friendly smoke preset:
    PYTHONPATH=src python examples/train_lm_torch.py --preset tiny --steps 60 \\
        --device cpu

The presets and flags are ``examples/train_lm.py``'s; checkpoints of the
two drivers share one on-disk format.
"""

import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import param_count
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer

PRESETS = {
    # ~130M params: GPT-2-small-class decoder-only LM
    "100m": dict(cfg=ModelConfig(
        name="lm-100m", family="dense", n_layers=10, d_model=640,
        n_heads=10, n_kv_heads=10, d_ff=2560, vocab=50304, head_dim=64,
        rope_theta=10000.0, block_pattern=("attn",), remat=True,
        q_block=128, kv_block=256),
        batch=4, seq_len=256),
    "tiny": dict(cfg=ModelConfig(
        name="lm-tiny", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab=2048, head_dim=32,
        rope_theta=10000.0, block_pattern=("attn",), remat=False,
        q_block=64, kv_block=64),
        batch=8, seq_len=64),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--no-terra", action="store_true",
                    help="bypass co-execution (debug)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    p = PRESETS[args.preset]
    trainer = Trainer(
        p["cfg"],
        OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                  total_steps=args.steps),
        ckpt_dir=args.ckpt_dir, batch=p["batch"], seq_len=p["seq_len"],
        log_every=10, ckpt_every=max(args.steps // 4, 20),
        use_terra=not args.no_terra, device=args.device)
    n = param_count(trainer.state_tree()["params"])
    print(f"model: {p['cfg'].name}  params={n / 1e6:.1f}M  "
          f"device={trainer.device}")
    if trainer.start_step:
        print(f"resumed from checkpoint at step {trainer.start_step}")
    hist = trainer.train(args.steps)
    print(f"final loss {hist[-1][1]:.4f} "
          f"(from {hist[0][1]:.4f} at step {hist[0][0]})")
    if trainer.straggler_events:
        print(f"straggler watchdog flagged {len(trainer.straggler_events)} "
              f"slow steps")
    if trainer.use_terra:
        print("terra stats:", {k: v for k, v in trainer._iteration.stats.items()
                               if isinstance(v, int)})
        trainer._iteration.close()


if __name__ == "__main__":
    main()
