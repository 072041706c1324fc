"""Time one checkout's SSD-scan kernels on the card by two timers.

    python3 tools/ssd_timers.py [SRC]

SRC is the ``src`` directory of a checkout of this repository (default:
this checkout's), so that two versions of the kernels can be timed on one
card, each in its own process (for example parent, change, change,
parent).  At both shapes of the mamba2-130m path (``chip_smoke.SSD_PATH``:
the serving prefill with the final state, the eval forward without it;
bf16, strided inputs, rotating over inputs larger than the L2) it prints
one JSON line per shape with three turns of (CUDA-event ms per call,
profiler device ms per call summed over the call's kernels) and the last
turn's per-kernel split, timed as ``chip_smoke.py`` phase 2 times them.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    src = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                          else os.path.join(HERE, "src"))
    sys.path[:0] = [src, HERE]
    import torch
    if not torch.cuda.is_available():
        print("ssd_timers: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops as kops
    for shape, (B, S, final) in cs.SSD_PATH.items():
        ins = [cs.ssd_inputs(B, S, cs.MAMBA_H, cs.MAMBA_P, cs.MAMBA_N,
                             torch.bfloat16, 100 + i, torch.bfloat16,
                             strided=True)
               for i in range(16 if B == 1 else 4)]
        call = cs.rotating([
            lambda t=t: kops.ssd_scan(*t, chunk=cs.MAMBA_CHUNK,
                                      return_final=final) for t in ins])
        runs = [(cs.time_ms(call, 40),) + cs.device_split(call, 40)
                for _ in range(3)]
        print(json.dumps({
            "src": os.path.relpath(src, HERE), "shape": shape,
            "x": [B, S, cs.MAMBA_H, cs.MAMBA_P], "N": cs.MAMBA_N,
            "final": final,
            "turns_events_device_ms": [[e, d] for e, d, _ in runs],
            "split_ms": runs[-1][2]}), flush=True)
        del ins, call
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
