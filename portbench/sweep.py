"""Find a serving cell's knee: the highest arrival rate its system
sustains without a growing backlog, by windows at several rates in one
process (one set-up, then one window a rate, lowest first).

    python3 portbench/sweep.py --workload <cell> --rates 2 3 4 5 \\
        --seconds 30 --seed 1

A line a rate: tokens/s, the 95th percentiles of time to first token and
of the gaps between tokens, and the median time to first token of the
first and the last third of the requests; a backlog that grows through
the window shows as a last third far above the first.  The cell's mix
then takes 0.8 x the knee as its ``rate``."""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.core import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    from portbench.core import devtrace, manifest, stats
    from portbench.drivers import serve
    cell = manifest.cell(args.workload)
    mix = cell.traffic
    cfg, _, sched = serve.build(cell, args.seed, "cuda")
    serve.warm_up(sched, cfg, mix, args.seed, args.seconds)
    for rate in sorted(args.rates):
        reqs, stamps, arrivals, *_ = serve.window(
            sched, cfg, mix, args.seed, args.seconds,
            devtrace.Tracer(False), rate=rate)
        tokens, last, ttft, itl, failed = serve.latencies(reqs, stamps,
                                                          arrivals)
        third = max(1, len(ttft) // 3)
        print(json.dumps({
            "rate": rate, "requests": len(reqs), "failed": failed,
            "tokens_per_s": tokens / (last - arrivals[0]),
            "drain_s": last - arrivals[0] - args.seconds,
            "ttft_p95_ms": 1e3 * stats.percentile(ttft, 95),
            "itl_p95_ms": 1e3 * stats.percentile(itl, 95),
            "ttft_first_third_ms": 1e3 * statistics.median(ttft[:third]),
            "ttft_last_third_ms": 1e3 * statistics.median(ttft[-third:]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
            flush=True)
    serve.release(sched)
    return 0


if __name__ == "__main__":
    sys.exit(main())
