"""Read a cell's correctness control, and the faults it must catch, at
the cell's own size, one JSON line a seed.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \
        [--parts program fp8 half_batch]

What is read is the cell's driver's (``drivers/<driver>.py``,
``control``): the plain reference computed in the nearest precision below
the configuration's, put in the program's place, and the planted faults
the cell can have.  The benchmark's own runs never run this; its readings
set the upper end of each limit in ``limits/<cell>.json``."""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.core import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", nargs="+",
                    help="the readings to take (a training cell's: "
                         "program, fp8, half_batch; default all)")
    args = ap.parse_args(argv)
    from portbench.core import manifest
    cell = manifest.cell(args.workload)
    drv = manifest.driver(cell.traffic["driver"])
    for seed in args.seeds:
        t = time.perf_counter()
        kw = {"parts": args.parts} if args.parts else {}
        got = drv.control(cell, seed, args.device, **kw)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
