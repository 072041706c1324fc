"""Time one checkout's SSD-scan kernels on the card by two timers.

    python3 tools/ssd_timers.py [SRC] [--bwd]

SRC is the ``src`` directory of a checkout of this repository (default:
this checkout's), so that two versions of the kernels can be timed on one
card, each in its own process (for example parent, change, change,
parent).  At both shapes of the mamba2-130m path (``chip_smoke.SSD_PATH``:
the serving prefill with the final state, the eval forward without it;
bf16, strided inputs, rotating over inputs larger than the L2) it prints
one JSON line per shape with three turns of (CUDA-event ms per call,
profiler device ms per call summed over the call's kernels) and the last
turn's per-kernel split, timed as ``chip_smoke.py`` phase 2 times them.
``--bwd`` times the scan's gradient (``ssd_scan_bwd``) instead, at the
launcher's training shape (``chip_smoke.SSD_TRAIN``, bf16, strided, two
rotating inputs), as ``chip_smoke.ssd_bwd_kernel_row`` times it, with
the gradient pass's registers and spills from the build log and, where
the checkout has it, its shared memory and CTAs a SM.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--bwd"]
    src = os.path.abspath(args[0] if args else os.path.join(HERE, "src"))
    sys.path[:0] = [src, HERE]
    import torch
    if not torch.cuda.is_available():
        print("ssd_timers: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops as kops
    if "--bwd" in sys.argv[1:]:
        return time_bwd(cs, kops, src)
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


def time_bwd(cs, kops, src) -> int:
    import torch
    from repro_torch.kernels import build
    SS = sys.modules["repro_torch.kernels.ssd_scan"]
    B, S = cs.SSD_TRAIN
    H, P, N = cs.MAMBA_H, cs.MAMBA_P, cs.MAMBA_N
    ins = [cs.ssd_inputs(B, S, H, P, N, torch.bfloat16, 700 + i,
                         torch.bfloat16, strided=True)
           + (cs.seeded((B, S, H, P), torch.bfloat16, 710 + i),)
           for i in range(2)]
    call = cs.rotating([lambda t=t: kops.ssd_scan_bwd(*t) for t in ins])
    events = [cs.time_ms(call, 10) for _ in range(3)]
    dev, split = cs.device_split(call, 10)
    occ = SS.grad_occupancy(N, P, torch.bfloat16) \
        if hasattr(SS, "grad_occupancy") else None
    regs = {k: [r, sp] for k, r, sp in
            cs.ptxas_entries(build.LOGS.get("ssd_scan", ""))
            if k.startswith("ssd_grad")}
    print(json.dumps({
        "src": os.path.relpath(src, HERE), "shape": "training",
        "x": [B, S, H, P], "N": N, "plan": list(SS.plan(B, S, H)),
        "turns_events_ms": events, "device_ms": dev, "split_ms": split,
        "grad_occupancy": occ, "registers_spills": regs}), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
