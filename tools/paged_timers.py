"""Time one checkout's paged-attention (or flash-attention) kernel on
the card.

    python3 tools/paged_timers.py [SRC] [--arch NAME ...] [--flash]

SRC is the ``src`` directory of a checkout of this repository (default:
this checkout's), so that two versions of the kernel can be timed on one
card, each in its own process (for example parent, change, change,
parent).  Without ``--arch`` (or with ``--arch llama3-8b``) it times
llama3-8b's serving shape (``kernels/ref.PAGED_SERVING``: 8 rows up to
512 tokens, 32/8 heads x 128, 16-token pages); with it, each named
family's decode shape from ``chip_smoke.PAGED_FAMILIES`` (its heads, head
dim, window and rows).
In bf16, rotating over arenas together larger than the L2, it prints one
JSON line a shape with three turns of profiler device ms per call (split
and combine kernels summed, and each kernel's share in the last turn),
timed as ``chip_smoke.py`` phase 2 times the kernel.  ``--flash`` times
the flash-attention kernel instead, at the shapes of ``chip_smoke.py``'s
flash rows on a main path: llama3-8b's scoring ([128, 512, 128], causal)
and whisper-small's encoder and cross-attention (``WHISPER_FLASH``).
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
    ap.add_argument("--flash", action="store_true",
                    help="time flash attention at the scoring shapes")
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path[:0] = [src, HERE]
    import torch
    if not torch.cuda.is_available():
        print("paged_timers: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if args.flash:
        return time_flash(cs, src)
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import PAGED_SERVING
    shapes = {}
    for arch in args.arch or ["llama3-8b"]:
        if arch == "llama3-8b":
            B, Hkv, G, D, bs, nbps, nblocks, valid = PAGED_SERVING
            shapes[arch] = (B, Hkv, G, D, bs, nbps, 0, valid, nblocks)
            continue
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


def time_flash(cs, src) -> int:
    import torch
    from repro_torch.kernels import ops as kops
    shapes = {"llama3-8b": (128, 512, 512, 128, True)}
    for name, sq, skv in cs.WHISPER_FLASH:
        shapes[f"whisper-small {name}"] = (cs.WHISPER_BH, sq, skv, 64, False)
    for label, (bh, sq, skv, d, causal) in shapes.items():
        qkv = [[cs.seeded((bh, 1, sq if j == 0 else skv, d), torch.bfloat16,
                          20 + 3 * i + j) for j in range(3)]
               for i in range(4)]
        call = cs.rotating([lambda t=t: kops.flash_attention(
            *t, causal=causal) for t in qkv])
        turns = [cs.device_ms(call, 20) for _ in range(3)]
        print(json.dumps({"src": os.path.relpath(src, HERE),
                          "flash": label, "shape": [bh, sq, skv, d, causal],
                          "turns_device_ms": turns,
                          "median_ms": sorted(turns)[1]}), flush=True)
        del qkv, call
        cs.release()
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
