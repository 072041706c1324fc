"""Quickstart on the PyTorch port: Terra imperative-symbolic co-execution
in 40 lines.

Write any imperative program against repro_torch.core.ops — dynamic
control flow, Python mutation, numpy calls included — wrap it with
terra.function, and the runtime traces, builds a symbolic graph, and
co-executes.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
(``--device`` defaults to the CUDA card; without one the program raises
unless ``--device cpu`` is given.)
"""

import argparse

import numpy as np

from repro_torch.core import GradientTape, Variable, function, ops


class Schedule:                      # Python object mutated mid-training
    lr = 0.1


def build(device=None):
    """(train_step, sched): the program and the object it reads, made in
    a function so that the engine's device is resolved when it runs."""
    # a 2-layer network as ordinary mutable Python state
    W1 = Variable(np.random.RandomState(0).randn(16, 32)
                  .astype(np.float32) * 0.2)
    W2 = Variable(np.random.RandomState(1).randn(32, 4)
                  .astype(np.float32) * 0.2)
    sched = Schedule()

    @function(optimize="all", device=device)   # full pass pipeline (§10)
    def train_step(x, y):
        with GradientTape() as tape:
            h = ops.relu(ops.matmul(x, W1.read()))
            logits = ops.matmul(h, W2.read())
            loss = ops.softmax_xent(logits, y)
        g1, g2 = tape.gradient(loss, [W1, W2])
        W1.assign_sub(ops.mul(g1, sched.lr))      # captured mutation
        W2.assign_sub(ops.mul(g2, sched.lr))
        return loss

    return train_step, sched


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    train_step, sched = build(args.device)
    rng = np.random.RandomState(42)
    for step in range(60):
        x = rng.randn(64, 16).astype(np.float32)
        y = (x.sum(axis=1) > 0).astype(np.int32)
        loss = train_step(x, y)
        if step == 30:
            sched.lr = 0.02           # Terra re-traces transparently
        if step % 10 == 0:
            print(f"step {step:3d}  loss {float(loss):.4f}  "
                  f"phase={train_step.phase}")
    print("stats:", {k: v for k, v in train_step.stats.items()
                     if isinstance(v, int)})
    train_step.close()


if __name__ == "__main__":
    main()
