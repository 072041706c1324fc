#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) end to end on one CUDA card.

    python3 chip_smoke.py                 # every phase (needs one H100)
    python3 chip_smoke.py --profile       # + steady-state decode timing

Phases, in order; any failure exits non-zero and prints no result:

1. build   — compile every hand-written kernel of the serving path from
             this checkout's sources (nvcc, sm_90a) and print the card.
2. kernels — each kernel against its plain PyTorch version on the card,
             over a sweep of shapes and at the serving path's own shape,
             with its time beside the plain version's, a PyTorch library
             call's and the least time the card could take (the bound).
3. serving — llama3-8b at its published width and depth (random bf16
             weights from a seed) served by the co-executed paged
             continuous-batching scheduler with the ``kernels`` pass: 12
             requests through 8 slots.  Launch counters are zeroed just
             before and read just after, and must show the kernel ran.
4. tokens  — full width, 4 layers, float32 (TF32 off for matmuls and
             cuDNN): greedy tokens with the kernel, with the gather path
             and with ``use_terra=False`` must be equal.
5. profile — only with ``--profile``: steady-state decode time per step,
             kernel path against gather path in turns, and a
             torch.profiler window (device time by kernel, busy share).

The line before the last is one JSON object of kernel measurements; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,  # dense tensor-core bf16
                  "float32": 67e12}    # f32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------

def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls, by CUDA
    events around the whole run (after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating(fns):
    """One callable that calls ``fns`` in turn."""
    state = [0]

    def call():
        fn = fns[state[0] % len(fns)]
        state[0] += 1
        return fn()
    return call


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: the paged-attention kernel against its plain version
# --------------------------------------------------------------------------

def paged_inputs(B, Hq, Hkv, D, bs, nbps, nblocks, valid, dtype, seed):
    """Random q / arena, block tables with distinct real blocks for each
    row's valid positions and trash block 0 in every tail entry."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, Hq, D).astype(np.float32)
    kp = rng.randn(nblocks, bs, Hkv, D).astype(np.float32)
    vp = rng.randn(nblocks, bs, Hkv, D).astype(np.float32)
    need = [-(-int(v) // bs) for v in valid]
    check(sum(need) <= nblocks - 1, "sweep shape needs more blocks")
    ids = rng.permutation(np.arange(1, nblocks))
    bt = np.zeros((B, nbps), np.int32)
    off = 0
    for b, n in enumerate(need):
        bt[b, :n] = ids[off:off + n]
        off += n
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a).to(dev, dtype)   # noqa: E731
    return (t(q), t(kp), t(vp), torch.from_numpy(bt).to(dev),
            torch.tensor(valid, dtype=torch.int32, device=dev))


def paged_bound_ms(q, kp, bt, valid, bs, window=0) -> float:
    """Least time for the work these inputs need: each valid (in-window)
    K/V position read once, q read and the output written once, the table
    entries of the blocks read; operations 4·Hq·D per position."""
    B, _, Hq, D = q.shape
    Hkv = kp.shape[2]
    el = q.element_size()
    vl = valid.tolist()
    pos = [min(v, window) if window else v for v in vl]
    blocks = sum(-(-v // bs) for v in vl)
    nbytes = (sum(pos) * Hkv * D * 2 * el + 2 * q.numel() * el
              + blocks * 4 + B * 4)
    ops = 4 * sum(pos) * Hq * D
    dt = str(q.dtype).replace("torch.", "")
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt])


def sdpa_dense(q, kp, vp, bt, valid):
    """The library yardstick: scaled_dot_product_attention over K/V already
    gathered into dense [B, Hkv, S, D] rows, with the valid-length mask.
    Returns a zero-argument callable (gather done outside it)."""
    import torch
    import torch.nn.functional as F
    B, _, Hq, D = q.shape
    Hkv = kp.shape[2]
    k = kp[bt.long()].reshape(B, -1, Hkv, D).transpose(1, 2).contiguous()
    v = vp[bt.long()].reshape(B, -1, Hkv, D).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()                   # [B, Hq, 1, D]
    pos = torch.arange(k.shape[2], device=q.device)
    mask = (pos[None, :] < valid[:, None])[:, None, None, :]
    try:
        F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qh, k, v, attn_mask=mask, enable_gqa=True)
    except TypeError:           # a torch without enable_gqa: expand heads
        ke = k.repeat_interleave(Hq // Hkv, 1)
        ve = v.repeat_interleave(Hq // Hkv, 1)
        return lambda: F.scaled_dot_product_attention(qh, ke, ve,
                                                      attn_mask=mask)


def phase_kernels():
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import ref_paged_attention

    # the tests/test_paged.py shapes, GQA 1 and 4, window 0 and 6
    for G in (1, 4):
        for window in (0, 6):
            for dtype in (torch.float32, torch.bfloat16):
                Hkv = 2
                args = paged_inputs(3, Hkv * G, Hkv, 16, 8, 4, 9, [5, 9, 16],
                                    dtype, seed=G * 10 + window)
                out = PA.paged_attention(*args, window=window)
                ref = ref_paged_attention(*args, window=window)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                name = str(dtype).replace("torch.", "")
                log(f"kernel sweep G={G} window={window} {name}: "
                    f"max_abs_err={err:.3e} (tol {TOL[name]})")
                check(err <= TOL[name], f"paged_attention disagrees: G={G} "
                      f"window={window} {name} err={err}")

    # the serving slice's own shape: llama3-8b heads, 8 slots x 512 tokens
    # in 16-token pages, ragged lengths, trash-block tails
    B, Hq, Hkv, D, bs, nbps, nblocks = 8, 32, 8, 128, 16, 32, 257
    valid = [1, 17, 100, 255, 256, 300, 444, 512]
    for dtype in (torch.float32, torch.bfloat16):
        args = paged_inputs(B, Hq, Hkv, D, bs, nbps, nblocks, valid, dtype,
                            seed=7)
        out = PA.paged_attention(*args)
        ref = ref_paged_attention(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        name = str(dtype).replace("torch.", "")
        log(f"kernel at the slice shape {name}: max_abs_err={err:.3e} "
            f"(tol {TOL[name]})")
        check(err <= TOL[name], f"paged_attention disagrees at the slice "
              f"shape ({name}): err={err}")
    q, kp, vp, bt, vl = args                         # bf16, as served

    # time over rotating copies of the arena (together > the 50 MB L2):
    # decode reads each layer's arena cold
    rot = [(kp.clone(), vp.clone()) for _ in range(8)]
    ms = time_ms(rotating([
        lambda k=k, v=v: PA.paged_attention(q, k, v, bt, vl)
        for k, v in rot]), 200)
    plain_ms = time_ms(rotating([
        lambda k=k, v=v: ref_paged_attention(q, k, v, bt, vl)
        for k, v in rot]), 50)
    lib_ms = time_ms(rotating([sdpa_dense(q, k, v, bt, vl)
                               for k, v in rot]), 200)
    bound = paged_bound_ms(q, kp, bt, vl, bs)
    log(f"paged_attention bf16 B={B} Hq={Hq} Hkv={Hkv} D={D} bs={bs} "
        f"nbps={nbps}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa(dense) {lib_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:75",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_ms}


# --------------------------------------------------------------------------
# phases 3 and 4: serving through the port's entry points
# --------------------------------------------------------------------------

def make_requests(cfg, n, seed, prompt_lo, prompt_hi, new_lo, new_hi):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        L = int(rng.randint(prompt_lo, prompt_hi + 1))
        out.append(Request(
            prompt=rng.randint(0, cfg.vocab, L).astype(np.int32),
            max_new_tokens=int(rng.randint(new_lo, new_hi + 1)),
            arrival_time=0.0))
    return out


SERVE_KW = dict(max_slots=8, max_len=512, page_size=16)
KERNELS = ("cse", "kernels", "dce", "coalesce")


def phase_serving(kernel_rows):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    log(f"llama3-8b: {n_params / 1e9:.3f} B params ({cfg.param_dtype}), "
        f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.1f} s")
    sched = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                        **SERVE_KW)
    reqs = make_requests(cfg, 12, seed=0, prompt_lo=16, prompt_hi=256,
                         new_lo=32, new_hi=64)
    # counts of the main path only: zeroed just before it, read just after
    PA.paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.paged_attention.launches
    st = sched.stats
    sched.close()

    for i, r in enumerate(reqs):
        check(r.out_tokens is not None
              and len(r.out_tokens) == r.max_new_tokens,
              f"request {i} got {len(r.out_tokens or [])} of "
              f"{r.max_new_tokens} tokens")
    check(st["phase"] == "co-execution", f"phase {st['phase']}")
    check(st["kernels_substituted"] >= 1, "kernels pass substituted nothing")
    # the kernel op runs in every decode step the compiled graph executes
    # (traced iterations run the op eagerly, unsubstituted): once per layer
    compiled_steps = st["iterations"] - st["traced_iterations"]
    check(st["iterations"] == st["decode_steps"],
          "engine iterations != scheduler decode steps")
    check(launches == compiled_steps * cfg.n_layers and launches > 0,
          f"paged_attention launches {launches} != (decode steps "
          f"{st['decode_steps']} - traced {st['traced_iterations']}) x "
          f"{cfg.n_layers} layers")
    gen = st["generated_tokens"]
    log(f"serving: {len(reqs)} requests, {gen} tokens in {wall:.2f} s = "
        f"{gen / wall:.1f} tokens/s (bring-up reading, includes tracing "
        f"and warm-up), decode steps {st['decode_steps']}, prefill steps "
        f"{st['prefill_steps']}, kernel launches {launches} = "
        f"{compiled_steps} compiled steps x {cfg.n_layers} layers")
    keys = ("phase", "iterations", "traced_iterations", "steady_iters",
            "retraces", "replays", "graph_versions", "families",
            "kernels_substituted", "segments_dispatched",
            "segments_recompiled", "admitted", "retired",
            "generated_tokens", "decode_steps", "prefill_steps",
            "donated_bytes")
    log("serving counters: " + json.dumps({k: st.get(k) for k in keys}))
    kernel_rows[0]["launches"] = launches
    del sched, params
    torch.cuda.empty_cache()


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def phase_profile(out_dir):
    """Steady-state decode at full width, kernel path against gather path,
    in turns (gather, kernel, kernel, gather), each arm warmed up first:
    host wall time per decode step, then one torch.profiler window over a
    kernel-path batch for device time by kernel and the device busy share.
    Writes the full table to ``out_dir``/profile_decode.txt."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg = get_config("llama3-8b")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    arms = {"kernel": ContinuousBatchingScheduler(cfg, params,
                                                  optimize=KERNELS,
                                                  **SERVE_KW),
            "gather": ContinuousBatchingScheduler(cfg, params,
                                                  optimize="safe",
                                                  **SERVE_KW)}

    def batch(sched, seed):
        """8 requests admitted together: one prefill, then 47 decode steps
        with all 8 slots active.  Returns (wall s, decode steps)."""
        reqs = make_requests(cfg, 8, seed, 128, 128, 48, 48)
        st0 = sched.stats["decode_steps"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.serve(reqs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sched.stats["decode_steps"] - st0

    for sched in arms.values():             # tracing + steady-state entry
        batch(sched, 100)
    for name in ("gather", "kernel", "kernel", "gather"):
        wall, steps = batch(arms[name], 101)
        log(f"profile {name}: {steps} decode steps + 1 prefill in "
            f"{wall * 1e3:.1f} ms = {wall / steps * 1e3:.2f} ms/decode step "
            f"(8 active slots, {8 * steps / wall:.1f} tokens/s)")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, steps = batch(arms["kernel"], 102)
    evts = [e for e in prof.key_averages() if _device_us(e) > 0]
    evts.sort(key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in evts) / 1e6
    lines = [f"kernel path, {steps} decode steps + 1 prefill, wall "
             f"{wall * 1e3:.1f} ms under the profiler; device busy "
             f"{busy * 1e3:.1f} ms = {100 * busy / wall:.1f}% of wall"]
    for e in evts[:40]:
        lines.append(f"{_device_us(e) / 1e3:10.3f} ms {e.count:7d} x  "
                     f"{e.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_decode.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:16]:
        log("profile: " + line)
    for sched in arms.values():
        sched.close()
    del arms, params
    torch.cuda.empty_cache()


def top2_gap(cfg, params, tokens) -> float:
    """Gap between the two largest next-token logits after ``tokens``
    (plain dense prefill), to tell a near-tie from a real disagreement."""
    import torch
    from repro_torch.models import model as M
    t = torch.tensor([tokens], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, _ = M.prefill(cfg, params, t, len(tokens))
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def phase_tokens():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("token equality: float32, allow_tf32=False for matmul and cuDNN")
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=4,
                              dtype="float32", param_dtype="float32")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(1))
    arms = {"kernel": dict(optimize=KERNELS),
            "gather": dict(optimize="safe"),
            "use_terra=False": dict(use_terra=False)}
    outs = {}
    for name, kw in arms.items():
        reqs = make_requests(cfg, 6, seed=1, prompt_lo=16, prompt_hi=128,
                             new_lo=16, new_hi=24)
        before = PA.paged_attention.launches
        sched = ContinuousBatchingScheduler(cfg, params, **SERVE_KW, **kw)
        sched.serve(reqs)
        st = sched.stats
        sched.close()
        outs[name] = reqs
        log(f"token arm {name}: {sum(len(r.out_tokens) for r in reqs)} "
            f"tokens, kernel launches "
            f"{PA.paged_attention.launches - before}, kernels_substituted "
            f"{st.get('kernels_substituted')}")
    base = outs["kernel"]
    for name in ("gather", "use_terra=False"):
        for i, (a, b) in enumerate(zip(base, outs[name])):
            if a.out_tokens == b.out_tokens:
                continue
            step = next(j for j, (x, y) in enumerate(
                zip(a.out_tokens, b.out_tokens)) if x != y)
            gap = top2_gap(cfg, params,
                           list(a.prompt) + a.out_tokens[:step])
            raise SmokeFailure(
                f"greedy tokens differ: kernel vs {name}, request {i}, step "
                f"{step}: {a.out_tokens[step]} vs {b.out_tokens[step]}, "
                f"top-2 logit gap {gap:.3e}")
    log("token equality: kernel == gather == use_terra=False on all "
        f"{len(base)} requests")
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time steady-state decode (kernel vs gather "
                         "path) and profile it into chiprun_out/")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)

    try:
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        built = build.build_all(["paged_attention"])
        log(f"build: {json.dumps(built)} (wall {time.perf_counter() - t0:.1f}"
            f" s)")
        for name, text in build.LOGS.items():
            regs = re.findall(r"Used (\d+) registers", text)
            spills = re.findall(r"(\d+) bytes spill stores", text)
            log(f"  ptxas[{name}]: {len(regs)} kernels, at most "
                f"{max(map(int, regs), default=0)} registers, at most "
                f"{max(map(int, spills), default=0)} bytes spill stores")
        smi = nvidia_smi_line()
        log(f"card: {smi}")
        rows = [phase_kernels()]
        phase_serving(rows)
        phase_tokens()
        if args.profile:
            phase_profile(os.path.join(HERE, "chiprun_out"))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
