"""What each part of the SSD scan's bf16 gradient pass costs on the card.

    python3 tools/ssd_grad_parts.py

Builds variants of ``csrc/ssd_scan.cu``, each with one part of
``ssd_grad_bf16`` switched off by a text edit of a copy of the source
(their gradients are wrong: timing only), and one with 8 warps a CTA
(``kCW = 2``) instead of 16.  Each variant is compiled by ``nvcc`` into
``kernels/_build/parts/`` (all at once) and timed in a process of its
own, in the order base, the variants, base: ``ssd_scan_bwd`` at the
launcher's training shape (``chip_smoke.SSD_TRAIN``, bf16, strided, two
rotating inputs), CUDA-event ms a call in three turns and the gradient
pass's profiler device time, one JSON line each.  A part's cost is the
base's time less the variant's.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "src")

# variant -> [(text in the source, its replacement)]; each text must occur
# exactly once
_LOOP_Z = ("    for (int kt = 0; kt < pw / 16; ++kt) {\n      uint32_t af[4];\n"
           "      ldsm_x4(af, A + (i0")
_LOOP_DU_B = ("        for (int k0 = 0; k0 < NK; k0 += 16) {\n"
              "          uint32_t af[4];\n          ldsm_x4(af, Bs + (i0")
_LOOP_DU_M = ("        for (int kt = m; kt < KT; ++kt) {\n"
              "          uint32_t ah[4], al[4];      // A[j][i] = M[i][j]")
_LOOP_TB = ("    for (int kt = 0; kt <= m; ++kt) {\n"
            "      uint32_t ah[4], al[4];          // A[i][j] = T[i][j]")
_LOOP_TC = ("    for (int kt = m; kt < KT; ++kt) {\n"
            "      uint32_t ah[4], al[4];          // A[j][i] = T[i][j]")
_CONV = ("#pragma unroll 4\n"
         "        for (int o = threadIdx.x; o < pw * n4; o += kTBG) {")
_TAILS = "    if (warp == kGW - 1) {\n      // dcs_k"
_STAGE = ("      if (k + 1 < items) stage_dyx(k + 1);",
          "      if (k + 1 < items) stage_raw(k + 1);")


def _off(text):
    return (text, "    if (0)\n" + text)


VARIANTS = {
    "base": [],
    "no Z, Z' products": [_off(_LOOP_Z)],
    "no du products": [_off(_LOOP_DU_B), _off(_LOOP_DU_M)],
    "no T.B, T^T.C products": [_off(_LOOP_TB), _off(_LOOP_TC)],
    "no hi + lo split of h_c, D_c": [(_CONV, "        if (0)\n" +
                                      _CONV.split("\n", 1)[1])],
    "no tails": [(_TAILS, _TAILS.replace("warp == kGW - 1", "0"))],
    "no loads after the first item": [(t, "") for t in _STAGE],
    "8 warps a CTA (kCW = 2)": [("constexpr int kCW = 4;",
                                 "constexpr int kCW = 2;")],
}


def build(out_dir):
    """{variant: library path}, compiled in parallel."""
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build as kb
    with open(os.path.join(kb.CSRC, "ssd_scan.cu")) as f:
        base = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs, libs = [], {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"ssd_grad_parts: {name!r}: the source no "
                                 f"longer holds {old!r} once")
            src = src.replace(old, new)
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(src)
        libs[name] = os.path.join(out_dir, f"libv{i}.so")
        procs.append((name, subprocess.Popen(
            [kb.nvcc()] + kb.NVCC_FLAGS + ["-o", libs[name], cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"ssd_grad_parts: {name!r} failed:\n{out}")
    return libs


def time_one(lib) -> dict:
    """Times ssd_scan_bwd with ``lib`` as the ssd_scan library."""
    import ctypes
    sys.path[:0] = [SRC, HERE]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import ops as kops
    kb._LIBS["ssd_scan"] = ctypes.CDLL(lib)
    B, S = cs.SSD_TRAIN
    H, P, N = cs.MAMBA_H, cs.MAMBA_P, cs.MAMBA_N
    ins = [cs.ssd_inputs(B, S, H, P, N, torch.bfloat16, 700 + i,
                         torch.bfloat16, strided=True)
           + (cs.seeded((B, S, H, P), torch.bfloat16, 710 + i),)
           for i in range(2)]
    call = cs.rotating([lambda t=t: kops.ssd_scan_bwd(*t) for t in ins])
    events = [cs.time_ms(call, 10) for _ in range(3)]
    _, split = cs.device_split(call, 10)
    return {"events_ms": events,
            "grad_pass_ms": sum(v for k, v in split.items()
                                if k.startswith("ssd_grad"))}


def main() -> int:
    if sys.argv[1:2] == ["--time"]:
        print(json.dumps(time_one(sys.argv[2])), flush=True)
        return 0
    libs = build(os.path.join(SRC, "repro_torch", "kernels", "_build",
                              "parts"))
    order = list(VARIANTS) + ["base"]
    for name in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time",
             libs[name]], capture_output=True, text=True, timeout=300)
        if out.returncode:
            print(f"ssd_grad_parts: {name!r}: {out.stderr[-2000:]}",
                  file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"variant": name, **row}), flush=True)
    sys.path[:0] = [SRC, HERE]
    import chip_smoke as cs
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
