"""Co-execution showcase on the PyTorch port: every failure class of
static converters (paper Figure 1 + §2.2) running in ONE imperative
program under Terra.

    PYTHONPATH=src python examples/coexec_showcase_torch.py
    PYTHONPATH=src python examples/coexec_showcase_torch.py --device cpu
(``--device`` defaults to the CUDA card; without one the program raises
unless ``--device cpu`` is given.)
"""

import argparse

import numpy as np

from repro_torch.core import GradientTape, Variable, function, ops


class Augment:                         # Fig 1c: mutated Python object
    noise = 0.0


def feature_gen(x, k):                 # Fig 1b: Python generator
    for i in range(k):
        yield ops.mul(x, float(i + 1))


def build(device=None):
    """(step, aug): the program and the object it reads, made in a
    function so that the engine's device is resolved when it runs."""
    aug = Augment()
    W = Variable(np.random.RandomState(0).randn(8, 8)
                 .astype(np.float32) * 0.3)

    @function(optimize="all", device=device)   # full pass pipeline (§10)
    def step(x, n_feats):
        try:                           # try/except (AutoGraph-unsupported)
            acc = ops.zeros_like(x)
            for f in feature_gen(x, n_feats):      # generator + dyn loop
                acc = ops.add(acc, f)
            h = ops.matmul(acc, W.read())
            if float(ops.reduce_sum(h)) > 1e4:     # materialization gating
                raise OverflowError
        except OverflowError:
            h = ops.mul(ops.matmul(x, W.read()), 0.1)

        h = ops.add(h, ops.mul(ops.random_normal(h.shape), aug.noise))
        hs = np.sort(h.numpy(), axis=1)            # Fig 1a: third-party call
        # third-party results flow back as Input Feeding points (np arrays
        # / np scalars are feeds; a bare Python float would be a baked
        # constant)
        loss = ops.reduce_mean(ops.square(ops.sub(h, np.float32(hs.mean()))))
        with GradientTape() as tape:
            out = ops.matmul(x, W.read())
            l2 = ops.reduce_mean(ops.square(out))
        g, = tape.gradient(l2, [W])
        W.assign_sub(ops.mul(g, 0.01))             # in-graph state update
        return loss

    return step, aug


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    step, aug = build(args.device)
    rng = np.random.RandomState(1)
    for i in range(16):
        if i == 8:
            aug.noise = 0.05           # mutation mid-run
        x = rng.randn(4, 8).astype(np.float32) * (10.0 if i == 12 else 1.0)
        loss = step(x, 2 + i % 3)
        print(f"iter {i:2d}  n_feats={2 + i % 3}  loss={float(loss):9.4f}  "
              f"phase={step.phase}")
    print("stats:", {k: v for k, v in step.stats.items()
                     if isinstance(v, int)})
    step.close()


if __name__ == "__main__":
    main()
