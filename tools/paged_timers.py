"""Time one checkout's paged-attention kernel on the card.

    python3 tools/paged_timers.py [SRC] [--arch NAME ...]

SRC is the ``src`` directory of a checkout of this repository (default:
this checkout's), so that two versions of the kernel can be timed on one
card, each in its own process (for example parent, change, change,
parent).  Without ``--arch`` it times llama3-8b's serving shape
(``kernels/ref.PAGED_SERVING``: 8 rows up to 512 tokens, 32/8 heads x
128, 16-token pages); with it, each named family's decode shape from
``chip_smoke.PAGED_FAMILIES`` (its heads, head dim, window and rows).
In bf16, rotating over arenas together larger than the L2, it prints one
JSON line a shape with three turns of profiler device ms per call (split
and combine kernels summed, and each kernel's share in the last turn),
timed as ``chip_smoke.py`` phase 2 times the kernel.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="?", default=os.path.join(HERE, "src"))
    ap.add_argument("--arch", nargs="*", default=[],
                    help="family shapes of chip_smoke.PAGED_FAMILIES")
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path[:0] = [src, HERE]
    import torch
    if not torch.cuda.is_available():
        print("paged_timers: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import PAGED_SERVING
    shapes = {}
    if not args.arch:
        B, Hkv, G, D, bs, nbps, nblocks, valid = PAGED_SERVING
        shapes["llama3-8b"] = (B, Hkv, G, D, bs, nbps, 0, valid, nblocks)
    for arch in args.arch:
        B, Hkv, G, D, bs, nbps, window, valid = cs.PAGED_FAMILIES[arch]
        nblocks = sum(-(-v // bs) for v in valid) + 1
        shapes[arch] = (B, Hkv, G, D, bs, nbps, window, valid, nblocks)
    for arch, (B, Hkv, G, D, bs, nbps, window, valid,
               nblocks) in shapes.items():
        q, kp, vp, bt, vl = cs.paged_inputs(B, Hkv * G, Hkv, D, bs, nbps,
                                            nblocks, valid, torch.bfloat16,
                                            seed=7)
        n_rot = min(8, max(2, -(-100 * 2**20 // (2 * kp.numel() * 2))))
        rot = [(kp.clone(), vp.clone()) for _ in range(n_rot)]
        call = cs.rotating([
            lambda k=k, v=v: PA.paged_attention(q, k, v, bt, vl,
                                                window=window)
            for k, v in rot])
        runs = [cs.device_split(call, 48) for _ in range(3)]
        turns = [total for total, _ in runs]
        print(json.dumps({"src": os.path.relpath(src, HERE), "arch": arch,
                          "shape": [B, Hkv * G, Hkv, D, bs, nbps, window],
                          "turns_device_ms": turns,
                          "median_ms": sorted(turns)[1],
                          "split_ms": runs[-1][1]}), flush=True)
        del q, kp, vp, bt, vl, rot, call
        cs.release()
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
