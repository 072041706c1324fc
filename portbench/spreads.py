"""The spread of each metric over sets of runs, and the bound it gives.

    python3 portbench/spreads.py A1.out A2.out ... -- B1.out B2.out ...

Each file holds one run's standard output (its last line is the result).
For each metric: each set's median and quartile spread (IQR ÷ median,
``statistics.quantiles(values, n=4)``), the wider spread, and five times
it as a bound, never under 1 % and never over the 25 % that a bound may
be at most (a metric marked ``capped`` spreads too widely for the rule:
it stands only while its spread stays well under half of 25 %).
``setup_s`` leaves out each set's first run, which builds the kernels."""

import json
import sys

from statistics import median

sys.path.insert(0, __file__.rsplit("/portbench/", 1)[0])

from portbench.core.stats import spread  # noqa: E402


def load(paths):
    out = []
    for p in paths:
        lines = [ln for ln in open(p).read().splitlines() if ln.strip()]
        out.append({k: v["value"] for k, v in
                    json.loads(lines[-1])["metrics"].items()})
    return out


def main(argv):
    cut = argv.index("--")
    sets = [load(argv[:cut]), load(argv[cut + 1:])]
    for name in sets[0][0]:
        cols = []
        for runs in sets:
            xs = [r[name] for r in runs]
            if name == "setup_s":
                xs = xs[1:]
            cols.append((median(xs), spread(xs)))
        wide = max(s for _, s in cols)
        bound = max(0.01, 5 * wide)
        print(f"{name:22s} " + "  ".join(
            f"median {m:.6g} spread {s * 100:.3f}%" for m, s in cols)
            + f"  bound {min(bound, 0.25) * 100:.2f}%"
            + ("  capped" if bound > 0.25 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
