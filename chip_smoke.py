#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) end to end on one CUDA card.

    python3 chip_smoke.py                 # every phase (needs one H100)
    python3 chip_smoke.py --only obs,persist   # the build and two phases
    python3 chip_smoke.py --only launch,parallel
    python3 chip_smoke.py --only dryrun,examples

Phases, in order; any failure exits non-zero and prints no result:

1. build    — compile every hand-written kernel (paged attention, rmsnorm,
              flash attention, SSD scan, causal conv) from this checkout's
              sources (one nvcc per source, all at once, sm_90a) and print
              the card.
2. kernels  — each kernel against its plain PyTorch version on the card,
              over a sweep of shapes (``kernels/ref.py``'s sweeps, shared
              with the tests) and at its main path's own shape, with its
              time beside the plain version's, a PyTorch library call's
              (kernel and library in three turns, by device time; the
              row keeps the median of each) and the least time the card
              could take (the bound); flash also at
              1024 tokens and paged also at 8 rows up to 2048 tokens
              (logged).  rmsnorm over ``RMS_SWEEP`` (both of its
              kernels), then the register kernel's CTA shapes in turns
              (logged).  The SSD scan over ``SSD_SWEEP``, also against
              its own decomposition (``ref.ssd_chunk_parallel``), and
              timed at both path shapes (the prefill [1, 1024] and the
              forward [4, 2048]): CUDA-event time per call beside the
              device time summed over the call's three kernels, split per
              kernel, with the scratch bytes, and with other head groups
              in turns (logged; the row: the default's median device
              time).  Then paged decode at each family's shape
              (deepseek-moe-16b 16/16 x 128, qwen2.5-14b 40/8 x 128,
              mixtral-8x22b 48/8 x 128 with window 4096 and rows up to
              6144 tokens, recurrentgemma-2b 10/1 x 256 with window
              2048), flash at D = 256 (10/1 heads, 512 and 4096
              tokens, causal, window 2048) and flash at whisper-small's
              encoder [48, 1500, 64] and cross [48, 128 x 1500, 64]
              shapes (no mask), each a row of its own with its time,
              bound, SDPA time and plain time.  The build
              log's registers and spills per kernel (every rmsnorm and
              SSD kernel, paged and flash at D 128 and 256).
2b. conv    — the causal depthwise conv with its SiLU and its gradient
              (``csrc/causal_conv.cu``) against their plain versions over
              ``ref.CONV_SWEEP`` (f32 and bf16; two calls equal to the
              bit), then timed in bf16 by CUDA events at mamba2-130m's
              training shape [16, 2048, 1792] and granite-4.0-h-small's
              prefill [1, 6720, 8448] beside the bound (bytes) and the
              plain version (the stack + einsum + SiLU), a training
              step's conv work (48 forwards, 24 gradients) and the
              kernels' registers and spills; two rows (launches from
              phase launch, which also counts 48 and 24 a step).
3. serving  — llama3-8b at its published width and depth (random bf16
              weights from a seed) served by the co-executed paged
              continuous-batching scheduler with the ``kernels`` pass: 12
              requests through 8 slots.  Launch counters are zeroed just
              before and read just after, and must show the kernel ran.
4. tokens   — full width, 4 layers, float32 (TF32 off for matmuls and
              cuDNN): greedy tokens with the kernel, with the gather path
              and with ``use_terra=False`` must be equal.
5. coexec-kernels — llama3-8b at full width and depth (bf16) scoring
              4 x 512 tokens per call with the imperative op-layer program
              ``llama_score_program`` through ``repro_torch.core.function``
              and its default ``optimize="all"``: every rms_norm runs the
              rmsnorm kernel and every attention chain the flash-attention
              kernel, 65 and 32 launches per compiled call (counters zeroed
              just before, read just after).  Then the unfused program
              (``optimize="safe"``) and the kernel one in turns.
6. coexec-equality — full width, 4 layers, float32 (TF32 off): the kernel
              program's scores equal the unfused program's within 1e-4.
7. mamba2-serving — mamba2-130m at its published width and depth (random
              bf16 weights from a seed) served by the co-executed
              continuous-batching scheduler: 24 requests through 16 slots,
              prompts 64-1024 tokens admitted at exact length.  Every
              prefill runs the SSD-scan kernel once per layer, decode none:
              launches == 24 x prefill steps (counters zeroed just before,
              read just after).
8. mamba2-equality — full width, 4 layers, float32 (TF32 off): greedy
              tokens equal on the card with co-execution, on the card with
              ``use_terra=False`` and on the CPU (``device="cpu"``, the
              plain chunked math); forward logits of [2, 512] tokens card
              vs CPU within 1e-4; one full-depth bf16 forward of [4, 2048]
              tokens (24 SSD launches, finite logits).
9. programs — the paper's ten imperative training programs
              (``repro_torch.programs``: tape autodiff, dropout, object
              mutation, numpy calls on fetched tensors, fetch-steered
              control flow), each through ``function`` ("terra") and
              ``imperative()``, 12 warm-up + 40 measured iterations as
              ``fig5_throughput.py`` counts them: ms per iteration, their
              ratio, the engine counters; every program reaches
              co-execution.  Then 20 iterations fetching each loss, float32
              with TF32 off, on the card and on the CPU: counters equal,
              losses within 1e-4 relative (dropblock too: its dropout mask
              is a counter hash, the same on both devices).
10. train   — ``Trainer`` at ``examples/train_lm.py``'s "100m" preset
              (10 layers, d_model 640, vocab 50304, remat, bf16; batch
              4 x 256 tokens): 40 co-executed steps with checkpoints at 20
              and 40, the loss must fall; the median step time with the
              card synced each step, the phase and the peak memory; a
              second ``Trainer`` resumes at step 40 and takes 10 steps.
              Then 2 layers at the same width in float32 (TF32 off), 8
              steps each from one step-0 checkpoint: card terra, card
              eager (``use_terra=False``) and CPU losses within 1e-3
              relative.  (mamba2 trains on the card in phase 16.)
11. capture — captured segments (``core/capture.py``) against
              ``disable_jit()``.  Equality, float32, TF32 off: llama3-8b
              decode (4 layers; co-executed with the kernels and
              ``use_terra=False``) and mamba2-130m serving (4 layers)
              give equal greedy tokens in all four arms; the scoring
              program (4 layers, 4 x 512) within phase 6's 1e-4; the
              trainer (2 layers of the 100m preset) within phase 10's
              PARITY_RTOL.  Each captured arm has every segment captured
              and none compiled eager.  Then full width, bf16, both arms
              in turns (three each) in one call: llama3-8b steady decode
              and scoring calls at 8 of 32 layers, mamba2 serving
              batches at 6 of 24, and 100m training steps at 5 of 10
              (depths cut to keep the script's wall), each with time per step, device time
              and busy share, peak memory, graphs, replays, recaptures
              and bytes copied into and out of graphs per step; in the
              captured windows the paged, flash and rmsnorm counters
              must advance by the profiler's launch counts.  Last, the
              closed engines must have returned their memory.
              Every earlier phase runs captured as well, with its launch
              assertions unchanged (a replay adds its graph's launches).
12. families — deepseek-moe-16b (28 layers, 64 routed top-6 +
              2 shared experts) and recurrentgemma-2b (26 layers, RG-LRU
              and local attention) at published width and depth, and
              mixtral-8x22b at published width cut to 4 of 56 layers,
              bf16 random weights from a seed, each served by the
              co-executed paged scheduler with the kernels pass (phase
              3's traffic; recurrentgemma 16 requests, prompts 64-1024 at
              exact length): paged launches == attention layers x
              compiled decode steps (counters zeroed just before, read
              just after), every segment captured; then steady decode
              (8 x 128 tokens, 32 new; deepseek and recurrentgemma at 8
              layers, FAMILY_TIMING_LAYERS) captured against
              ``disable_jit()`` in turns: step time, tokens/s, device
              busy share, peak memory, graphs and replays.  qwen2.5-14b
              (48 layers, 40/8 heads: the paged kernel at G = 5) is
              served once the same way at published width and depth,
              with its launches checked, and not timed.  Then at 4
              layers (recurrentgemma 5: one super-block and its two
              extra blocks), float32, TF32 off: greedy tokens equal
              across ServingEngine co-executed, ServingEngine
              ``use_terra=False``, the scheduler and ServingEngine on
              the CPU; a batch-size change re-traces and keeps them.
13. cross   — whisper-small (12 encoder + 12 decoder layers, d 768,
              vocab 51865) at published width and depth scores 4 audio x
              1500 frames against 128-token transcripts with the imperative
              op-level program ``whisper_score_program`` through
              ``function`` and its default ``optimize="all"``: each layer
              pair's three attentions (the encoder's bidirectional 1500 x
              1500, the decoder's causal one, its cross-attention 128 x
              1500) run the flash kernel, 36 substitutions a graph, flash
              launches == 36 x compiled calls (counters zeroed just
              before, read just after), unfused and kernel programs in
              turns; then float32 (TF32 off): kernel scores against the
              unfused program's and the CPU's within 1e-4.  Then
              whisper-small (full) and llama-3.2-vision-90b (full width, 10
              of 100 layers: two super-blocks, 8 self-attention and 2 gated
              cross layers, 10.66 B params) served lock-step by
              ``ServingEngine.run_batch`` (8 requests, 64 / 128-token
              prompts, 32 new; seeded frame embeddings [8, 1500, 768] f32
              or vision states [8, 1600, 8192] bf16), co-executed ==
              ``use_terra=False`` tokens, then captured against
              ``disable_jit()`` in turns: time to the first token (encode +
              prefill), decode ms a step, busy share, peak memory, and the
              device time a step spends re-projecting the cross K/V.  Last,
              float32 at 2 + 2 layers (whisper) and 5 (the VLM, one
              super-block): greedy tokens equal co-executed,
              ``use_terra=False``, captured, under ``disable_jit()`` and on
              the CPU; a whisper decode step with and without the encoder
              states gives different tokens.
14. obs     — the observability layer (repro_torch.obs) on llama3-8b at
              full width and depth (bf16, paged, co-executed, the kernels
              pass): one batch of 8 requests (prompts 96-128, 48 new)
              decoded with everything off, then with ``enable_metrics()``,
              ``RequestTraceProcessor``, ``JsonlSink`` and
              ``TraceViewerExporter`` attached, then with
              ``set_profile(1)`` as well (decode ms a step in each: the
              tracing ratio); greedy tokens equal in all three.  Every
              sampled decode step names ``kernel.slot_decode_paged``, and
              its CUDA-event device time is at most its closure's host
              wall; three single decode steps, each under its own
              torch.profiler window, have device time at least the
              profiler's paged-kernel time.  The registry's TTFT count
              equals the requests served and its token count the tokens
              generated (TTFT and TPOT p50/p99 beside the scheduler's own
              clock); ``/metrics`` scraped from ``MetricsServer`` on
              loopback parses as Prometheus text; the JSONL loads with
              ``load_jsonl``; ``obs.report`` writes the segment table and
              a ``.trace.json`` with monotone tracks and complete request
              flows (files in chiprun_out/).  Then the scoring program
              through ``function(profile=2, optimize="all")``: sampled
              segments name ``kernel.attention`` and ``kernel.rms_norm``.
15. persist — warm boots: two child processes in turn (this script with
              ``--persist-child``), sharing a ``$TERRA_CACHE_DIR`` in a
              temporary directory, each serving llama3-8b (full width and
              depth, bf16) through the co-executed paged scheduler (4
              first requests, then phase 3's 12) and scoring 4 calls of
              4 x 512 tokens through ``function``: the warm boot shows
              ``retraces`` 0, ``segments_recompiled`` 0, warm families,
              AOT loads and artifact hits, tokens and the compiled calls'
              scores equal to the cold boot's (<= 1e-6), and the same
              launches per compiled step and call; time to the first
              token, to the first score and to co-execution cold against
              warm, artifact bytes, graphs captured anew.  Then a
              llama3-8b scheduler checkpointed mid-run (requests in flight
              and queued, the paged arena copied to the host), restored
              into a fresh scheduler: the remaining tokens equal an
              uninterrupted run's; and an engine checkpoint of the gpt2
              program: the restored engine's losses equal the donor's.
              Checkpoint bytes, save and restore walls.
16. launch  — ``python -m repro_torch.launch.train`` (``main``, in a
              child process of this script) trains mamba2-130m at
              published width and depth (24 layers, d 768, vocab 50280,
              bf16, remat) on 8 x 2048 tokens (8 chunks of 256) through
              co-execution: 20 steps and a checkpoint, then a second
              child resumes at step 20 ("auto-resumed from step 20") and
              takes 10 more.  The loss must fall; each step's forward
              launches the SSD-scan kernel once a layer and its remat
              recompute once more (launches == 48 x steps) and its
              backward the gradient kernel once a layer (ssd_scan_bwd
              launches == 24 x steps; counters zeroed just before, read
              just after, in the child); the median step time (each step
              waited for) and the peak memory.  Then ``SSDScan`` at that
              shape against all-plain autograd (f32 and bf16: the forward
              within SSD_TOL, the gradients within f32 1e-4 and bf16
              5e-2 of the largest value) and its kernel row
              ``ssd_scan[mamba2 training 8x2048]`` (time a call by CUDA
              events, bound, plain time, the first child's launches).  Then 2 layers in
              float32 (TF32 off), the launcher in this process: steps
              21-30 of a resumed run equal an unbroken 30-step run's
              within 1e-3 (2 x 2048 tokens), and 8 steps on the card
              (kernel forward and backward) equal 8 on the CPU (plain)
              within PARITY_RTOL (1 x 512), both from one step-0
              checkpoint.
17. parallel — the parallel layer on a one-process NCCL group:
              ``dp_allreduce`` bf16 on CUDA tensors (mean + residual
              gives the gradient back) and deepseek-moe-16b at
              published width (2 of 28 layers, bf16) with
              ``moe_impl="shard_map"`` on a (1, 1) mesh against the
              ``moe_block`` path.
18. dryrun  — ``repro_torch.launch.dryrun.run_cell`` (no card: ``meta``
              tensors over a fake 256-rank group) for llama3-8b x
              decode_32k, mamba2-130m x train_4k and mamba2-130m x
              decode_32k on the production mesh: status ``ok`` and
              ``torch.cuda.memory_allocated()`` unmoved; the analytic roofline terms logged.  Then the dry
              run at phase launch's own shape (mamba2-130m, 1 x 1 mesh,
              8 x 2048, remat full): its compute and memory terms and
              peak bytes beside the launch phase's measured median step
              and peak (logged, no gate).
19. examples — ``examples/{serve_continuous,quickstart,coexec_showcase}
              _torch.py``'s ``main()`` on the card: serve_continuous
              retires every request in co-execution with no retrace;
              quickstart's and coexec_showcase's printed losses and
              phases equal the same program's on the CPU (losses within
              1e-3 as printed; coexec_showcase's iterations 0-7, where
              its noise is 0.0) and so do their int stats.

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
if HERE not in sys.path:        # loaded by path: the benchmark sits beside it
    sys.path.insert(0, HERE)

# the card's published peaks and the paged bound: the benchmark's own
from portbench.roofline import bounds  # noqa: E402
from portbench.roofline.peaks import HBM_BYTES_PER_S, OPS_PER_S  # noqa: E402

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


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn()``: the summed device
    time of the kernels it launched (:func:`device_split`).  For work
    shorter than its own launch, where back-to-back CUDA-event timing
    measures the host's launch rate instead."""
    return device_split(fn, iters, warmup)[0]


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profiled(run):
    """One torch.profiler window of device activity over ``run()``, the
    card synced before it and inside it after ``run()``: (what ``run()``
    returned, its wall seconds, [(kernel, device us, launches)] of every
    kernel with device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, [(e.key, us, e.count) for e in prof.key_averages()
                       if (us := _device_us(e)) > 0]


def device_split(fn, iters: int, warmup: int = 3):
    """(total, {kernel: ms}) per call of ``fn()``: the device time of each
    kernel it launched, from one torch.profiler window, for a call that
    launches several kernels."""
    def calls():
        for _ in range(iters):
            fn()

    for _ in range(warmup):
        fn()
    for _ in range(3):          # a window that caught no kernel is retaken
        split = {}
        for key, us, _ in profiled(calls)[2]:
            key = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", key)
            split[key] = split.get(key, 0.0) + us / 1e3 / iters
        if split:
            return sum(split.values()), split
    raise SmokeFailure("the profiler recorded no device time")


def turns(kernel, library, iters, n=3):
    """(kernel ms, library ms) by device time, taken in turns ``n`` times
    in one call (their difference can be near the spread between calls),
    and the median of each: a profiler window now and then records only
    part of its kernels, and the median keeps such a turn out."""
    got = [(device_ms(kernel, iters), device_ms(library, iters))
           for _ in range(n)]
    return got, sorted(k for k, _ in got)[n // 2], \
        sorted(v for _, v in got)[n // 2]


def rotating(fns):
    """One callable that calls ``fns`` in turn."""
    state = [0]

    def call():
        fn = fns[state[0] % len(fns)]
        state[0] += 1
        return fn()
    return call


def release():
    """Free the device memory a finished phase held: a closed engine sits
    in reference cycles (with the parameters its variables hold) until
    the cyclic collector runs."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def ptxas_entries(text):
    """(kernel, registers, spill-store bytes) for each entry function in
    ``nvcc -Xptxas -v`` output; kernel names shortened from their mangled
    form to ``name<type,ints>``."""
    out, cur, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append((_short_kernel(cur), int(m.group(1)), spill))
            cur = None
    return out


def _short_kernel(mangled: str) -> str:
    """``name<args>`` of a kernel in the anonymous namespace from its
    mangled name: bf16, f32 and integer template arguments."""
    m = re.match(r"_ZN(\d+)", mangled)
    n = m and re.compile(r"(\d+)").match(mangled, m.end() + int(m.group(1)))
    if not n:
        return mangled[:60]
    end = n.end() + int(n.group(1))
    name, args, k = mangled[n.end():end], [], end + 1
    # a repeated __nv_bfloat16 is a substitution (S<n>_); f32 never is
    tok = re.compile(r"13__nv_bfloat16|S\d*_|Li(\d+)E|Lb([01])E|f")
    while mangled.startswith("I", end) and k < len(mangled) \
            and mangled[k] != "E":
        t = tok.match(mangled, k)
        if not t:
            break
        if t.group(2) is not None:          # a bool argument
            args.append("true" if t.group(2) == "1" else "false")
        else:
            args.append(t.group(1)
                        or ("f32" if t.group(0) == "f" else "bf16"))
        k = t.end()
    return f"{name}<{','.join(args)}>" if args else name


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# the imperative llama3-8b scoring program (phases 5 and 6)
# --------------------------------------------------------------------------

def llama_score_program(core, cfg, params, batch, seq, **function_kw):
    """An imperative program that scores token sequences with a llama
    model, written against a package's op layer: ``core`` is
    ``repro_torch.core`` or the JAX package's ``repro.core`` (the CPU
    tests run this same text through both).  ``params`` is
    ``models.model.init_params``'s stacked layout in that package's
    arrays.  Returns ``core.function(step, **function_kw)``, where
    ``step(tokens)`` takes int32 ``[batch, seq]`` tokens and returns
    ``(scores, order, last_logits)``: the per-sequence mean next-token
    log-likelihood (numpy), the sequences ranked best first by numpy, and
    the logits after each sequence's last token ([batch, vocab], not
    materialised).

    The per-layer leaves become ``Variable``s of ``leaf[i]`` before the
    function is made: views of the stacked tensors in the port (no extra
    device memory), copies in the JAX package.  RoPE's cos/sin tables are
    numpy feeds.  The causal bias ``(tril - 1) * 1e9`` is built in the
    graph from a feed of the S positions, which the ``fold`` pass bakes
    (an [S, S] mask feed would exceed its 64 KB limit at real lengths), so
    the pass can evaluate the bias; the attention chain is spelled as
    ``kernel_sub`` matches it, so under the ``kernels`` pass each layer's
    attention becomes ``kernel.attention`` and each ``rms_norm`` (2 per
    layer and a final one) ``kernel.rms_norm``.
    """
    import numpy as np
    ops, Variable = core.ops, core.Variable
    B, S = batch, seq
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    half, dt = D // 2, cfg.dtype
    # models/layers.py:rope's tables, [S, 1, D/2] in float32
    freqs = np.float32(1.0) / (np.float32(cfg.rope_theta) ** (
        np.arange(half, dtype=np.float32) / np.float32(half)))
    ang = np.arange(S, dtype=np.float32)[:, None] * freqs[None, :]
    cos_tab, sin_tab = np.cos(ang)[:, None, :], np.sin(ang)[:, None, :]
    pos = np.arange(S, dtype=np.float32)

    blk = params["blocks"][0]             # the "attn" pattern slot, stacked
    names = {"norm1": ("norm1", "scale"), "norm2": ("norm2", "scale"),
             "wq": ("attn", "wq"), "wk": ("attn", "wk"),
             "wv": ("attn", "wv"), "wo": ("attn", "wo"),
             "w_gate": ("mlp", "w_gate"), "w_up": ("mlp", "w_up"),
             "w_down": ("mlp", "w_down")}
    layers = [{k: Variable(blk[a][b][i], f"layer{i}.{k}")
               for k, (a, b) in names.items()}
              for i in range(cfg.n_layers)]
    embed = Variable(params["embed"], "embed")
    final_norm = Variable(params["final_norm"]["scale"], "final_norm")
    head = Variable(params["embed" if cfg.tie_embeddings else "lm_head"],
                    "lm_head")

    def norm(x, scale):
        return ops.rms_norm(x, ops.add(1.0, scale), eps=1e-6)

    def rope(x, cos, sin):                # x [B, S, n, D]
        x1 = ops.getitem(x, idx=(Ellipsis, slice(0, half)))
        x2 = ops.getitem(x, idx=(Ellipsis, slice(half, None)))
        out = ops.concat(ops.sub(ops.mul(x1, cos), ops.mul(x2, sin)),
                         ops.add(ops.mul(x2, cos), ops.mul(x1, sin)),
                         axis=-1)
        return ops.cast(out, dtype=dt)

    def heads(x, n):                      # [B, S, n*D] -> [B, n, S, D]
        return ops.transpose(ops.reshape(x, new_shape=(B, S, n, D)),
                             axes=(0, 2, 1, 3))

    def layer(p, x, cos, sin, bias):
        h = norm(x, p["norm1"])
        q = rope(ops.reshape(ops.matmul(h, p["wq"]), new_shape=(B, S, H, D)),
                 cos, sin)
        k = rope(ops.reshape(ops.matmul(h, p["wk"]),
                             new_shape=(B, S, Hkv, D)), cos, sin)
        q = ops.reshape(ops.transpose(q, axes=(0, 2, 1, 3)),
                        new_shape=(B * H, S, D))
        # K/V heads repeated to the query heads (GQA: head h reads KV head
        # h // (H / Hkv)), heads folded into the batch axis
        k = ops.transpose(k, axes=(0, 2, 1, 3))
        v = heads(ops.matmul(h, p["wv"]), Hkv)
        k, v = (ops.reshape(ops.stack_op(*[t] * (H // Hkv), axis=2),
                            new_shape=(B * H, S, D)) for t in (k, v))
        s = ops.einsum(q, k, expr="bsd,btd->bst")
        s = ops.add(ops.mul(s, D ** -0.5), bias)
        o = ops.einsum(ops.softmax(s, axis=-1), v, expr="bst,btd->bsd")
        # the unfused chain comes out in float32 (f32 bias, f32 softmax),
        # kernel.attention in q's dtype: one cast keeps both in dt
        o = ops.cast(o, dtype=dt)
        o = ops.reshape(ops.transpose(ops.reshape(o, new_shape=(B, H, S, D)),
                                      axes=(0, 2, 1, 3)),
                        new_shape=(B, S, H * D))
        x = ops.add(x, ops.matmul(o, p["wo"]))
        h = norm(x, p["norm2"])
        m = ops.mul(ops.silu(ops.matmul(h, p["w_gate"])),
                    ops.matmul(h, p["w_up"]))
        return ops.add(x, ops.matmul(m, p["w_down"]))

    def step(tokens):
        tokens = np.asarray(tokens, np.int32)
        # one line per op: a TraceGraph node is (op, attrs, program line,
        # sources), and these two differ only in their feeds' values
        cos = ops.identity(cos_tab)
        sin = ops.identity(sin_tab)
        tril = ops.cast(ops.greater_equal(ops.reshape(pos, new_shape=(S, 1)),
                                          ops.reshape(pos, new_shape=(1, S))),
                        dtype="float32")
        bias = ops.mul(ops.sub(tril, 1.0), 1e9)        # causal (tril-1)*1e9
        x = ops.cast(ops.embedding(embed, tokens), dtype=dt)
        for p in layers:
            x = layer(p, x, cos, sin, bias)
        logits = ops.matmul(norm(x, final_norm), ops.transpose(head))
        logp = ops.log_softmax(
            ops.cast(ops.getitem(logits, idx=(slice(None), slice(0, S - 1))),
                     dtype="float32"), axis=-1)
        hit = ops.one_hot(np.ascontiguousarray(tokens[:, 1:]),
                          depth=cfg.vocab, dtype="float32")
        ll = ops.reduce_mean(ops.reduce_sum(ops.mul(logp, hit), axis=-1),
                             axis=-1)
        scores = np.asarray(ll.numpy(), np.float64)    # materialised
        order = np.argsort(-scores, kind="stable")     # ranked by numpy
        if not np.isfinite(scores).all():              # a Python branch on it
            raise FloatingPointError(f"non-finite scores {scores}")
        return scores, order, ops.getitem(logits, idx=(slice(None), -1))

    return core.function(step, **function_kw)


# --------------------------------------------------------------------------
# the imperative whisper-small scoring program (phase cross)
# --------------------------------------------------------------------------

def whisper_score_program(core, cfg, params, batch, seq, frames,
                          **function_kw):
    """An imperative program that scores candidate transcripts against
    audio with a Whisper model (n-best rescoring), written against a
    package's op layer as :func:`llama_score_program` is: ``core`` is
    ``repro_torch.core`` or the JAX package's ``repro.core``, ``params``
    ``models.model.init_params``'s layout in that package's arrays.
    Returns ``core.function(step, **function_kw)``, where ``step(tokens,
    audio)`` takes int32 ``[batch, seq]`` transcripts and float32
    ``[batch, frames, d_model]`` frame embeddings and returns ``(scores,
    order, last_logits)`` as the llama program does.

    The encoder runs over the frames (plus ``enc_pos``) with RoPE and with
    ``layer_norm`` taken in float32, as ``models/`` run it; the decoder
    runs with RoPE and a causal bias built in the graph from a
    positions feed (which ``fold`` bakes), then a cross-attention over the
    encoder states in each layer; the MLPs are SwiGLU.  Each attention is
    spelled as ``kernel_sub`` matches it, so under the ``kernels`` pass
    each becomes ``kernel.attention``: the encoder's bidirectional one (no
    bias, frames x frames), the decoder's causal one and its cross one (no
    bias, seq x frames) — 3 substitutions for each pair of an encoder and
    a decoder layer.
    """
    import numpy as np
    ops, Variable = core.ops, core.Variable
    B, S, T = batch, seq, frames
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    half, dt = D // 2, cfg.dtype
    freqs = np.float32(1.0) / (np.float32(cfg.rope_theta) ** (
        np.arange(half, dtype=np.float32) / np.float32(half)))

    def rope_tables(n):                  # [n, 1, D/2] in float32
        ang = np.arange(n, dtype=np.float32)[:, None] * freqs[None, :]
        return np.cos(ang)[:, None, :], np.sin(ang)[:, None, :]

    cos_tab, sin_tab = rope_tables(S)
    enc_cos_tab, enc_sin_tab = rope_tables(T)
    pos = np.arange(S, dtype=np.float32)

    def var_layers(stack, names, n, tag):
        return [{k: Variable(stack[a][b][i], f"{tag}{i}.{k}")
                 for k, (a, b) in names.items()} for i in range(n)]

    def attn_names(group):
        return {k: (group, k) for k in ("wq", "wk", "wv", "wo")}

    mlp = {k: ("mlp", k) for k in ("w_gate", "w_up", "w_down")}
    norms = {f"{n}.{w}": (n, w) for n in ("norm1", "norm2", "norm3")
             for w in ("scale", "bias")}
    enc = var_layers(params["encoder"], {
        **attn_names("attn"), **mlp,
        **{k: v for k, v in norms.items() if not k.startswith("norm3")}},
        cfg.enc_layers, "enc")
    dec = var_layers(params["blocks"][0], {
        **attn_names("attn"), **mlp, **norms,
        **{f"x{k}": ("cross", k) for k in ("wq", "wk", "wv", "wo")}},
        cfg.n_layers, "dec")
    enc_pos = Variable(params["enc_pos"], "enc_pos")
    enc_norm = {w: Variable(params["enc_final_norm"][w], f"enc_norm.{w}")
                for w in ("scale", "bias")}
    fin_norm = {w: Variable(params["final_norm"][w], f"final_norm.{w}")
                for w in ("scale", "bias")}
    embed = Variable(params["embed"], "embed")
    head = Variable(params["embed" if cfg.tie_embeddings else "lm_head"],
                    "lm_head")

    def ln(x, scale, bias):              # in float32, cast back
        y = ops.layer_norm(ops.cast(x, dtype="float32"), scale, bias,
                           eps=1e-5)
        return ops.cast(y, dtype=dt)

    def rope(x, cos, sin):               # x [B, S, H, D]
        x1 = ops.getitem(x, idx=(Ellipsis, slice(0, half)))
        x2 = ops.getitem(x, idx=(Ellipsis, slice(half, None)))
        out = ops.concat(ops.sub(ops.mul(x1, cos), ops.mul(x2, sin)),
                         ops.add(ops.mul(x2, cos), ops.mul(x1, sin)),
                         axis=-1)
        return ops.cast(out, dtype=dt)

    def heads(x, n, h=H):                # [B, n, h*D] -> [B*H, n, D]
        x = ops.transpose(ops.reshape(x, new_shape=(B, n, h, D)),
                          axes=(0, 2, 1, 3))
        if h != H:                       # GQA: KV head j serves H/h heads
            x = ops.stack_op(*[x] * (H // h), axis=2)
        return ops.reshape(x, new_shape=(B * H, n, D))

    def merge(o, n):                     # [B*H, n, D] -> [B, n, H*D]
        return ops.reshape(ops.transpose(
            ops.reshape(o, new_shape=(B, H, n, D)), axes=(0, 2, 1, 3)),
            new_shape=(B, n, H * D))

    def attend(q, k, v, n):              # no bias: kernel_sub's full form
        s = ops.mul(ops.einsum(q, k, expr="bsd,btd->bst"), D ** -0.5)
        return merge(ops.einsum(ops.softmax(s, axis=-1), v,
                                expr="bst,btd->bsd"), n)

    def ffn(p, x, norm):
        h = ln(x, p[f"{norm}.scale"], p[f"{norm}.bias"])
        m = ops.mul(ops.silu(ops.matmul(h, p["w_gate"])),
                    ops.matmul(h, p["w_up"]))
        return ops.add(x, ops.matmul(m, p["w_down"]))

    def enc_layer(p, x, cos, sin):       # RoPE, as models/attention.py
        h = ln(x, p["norm1.scale"], p["norm1.bias"])
        q = rope(ops.reshape(ops.matmul(h, p["wq"]), new_shape=(B, T, H, D)),
                 cos, sin)
        k = rope(ops.reshape(ops.matmul(h, p["wk"]),
                             new_shape=(B, T, Hkv, D)), cos, sin)
        o = attend(heads(ops.reshape(q, new_shape=(B, T, H * D)), T),
                   heads(ops.reshape(k, new_shape=(B, T, Hkv * D)), T, Hkv),
                   heads(ops.matmul(h, p["wv"]), T, Hkv), T)
        x = ops.add(x, ops.matmul(o, p["wo"]))
        return ffn(p, x, "norm2")

    def dec_layer(p, x, states, cos, sin, bias):
        h = ln(x, p["norm1.scale"], p["norm1.bias"])
        q = rope(ops.reshape(ops.matmul(h, p["wq"]), new_shape=(B, S, H, D)),
                 cos, sin)
        k = rope(ops.reshape(ops.matmul(h, p["wk"]),
                             new_shape=(B, S, Hkv, D)), cos, sin)
        q = ops.reshape(ops.transpose(q, axes=(0, 2, 1, 3)),
                        new_shape=(B * H, S, D))
        k = heads(ops.reshape(k, new_shape=(B, S, Hkv * D)), S, Hkv)
        s = ops.einsum(q, k, expr="bsd,btd->bst")
        s = ops.add(ops.mul(s, D ** -0.5), bias)
        o = ops.einsum(ops.softmax(s, axis=-1),
                       heads(ops.matmul(h, p["wv"]), S, Hkv),
                       expr="bst,btd->bsd")
        # f32 out of the biased chain, q's dtype out of kernel.attention
        o = ops.cast(o, dtype=dt)
        x = ops.add(x, ops.matmul(merge(o, S), p["wo"]))
        h = ln(x, p["norm2.scale"], p["norm2.bias"])
        o = attend(heads(ops.matmul(h, p["xwq"]), S),
                   heads(ops.matmul(states, p["xwk"]), T, Hkv),
                   heads(ops.matmul(states, p["xwv"]), T, Hkv), S)
        x = ops.add(x, ops.matmul(o, p["xwo"]))
        return ffn(p, x, "norm3")

    def step(tokens, audio):
        tokens = np.asarray(tokens, np.int32)
        # one line per op: feeds of one aval on one line are one node
        x = ops.cast(audio, dtype=dt)
        x = ops.add(x, ops.getitem(enc_pos, idx=(slice(0, T),)))
        cos = ops.identity(enc_cos_tab)
        sin = ops.identity(enc_sin_tab)
        for p in enc:
            x = enc_layer(p, x, cos, sin)
        states = ln(x, enc_norm["scale"], enc_norm["bias"])
        cos = ops.identity(cos_tab)
        sin = ops.identity(sin_tab)
        tril = ops.cast(ops.greater_equal(ops.reshape(pos, new_shape=(S, 1)),
                                          ops.reshape(pos, new_shape=(1, S))),
                        dtype="float32")
        bias = ops.mul(ops.sub(tril, 1.0), 1e9)        # causal (tril-1)*1e9
        x = ops.cast(ops.embedding(embed, tokens), dtype=dt)
        for p in dec:
            x = dec_layer(p, x, states, cos, sin, bias)
        logits = ops.matmul(ln(x, fin_norm["scale"], fin_norm["bias"]),
                            ops.transpose(head))
        logp = ops.log_softmax(
            ops.cast(ops.getitem(logits, idx=(slice(None), slice(0, S - 1))),
                     dtype="float32"), axis=-1)
        hit = ops.one_hot(np.ascontiguousarray(tokens[:, 1:]),
                          depth=cfg.vocab, dtype="float32")
        ll = ops.reduce_mean(ops.reduce_sum(ops.mul(logp, hit), axis=-1),
                             axis=-1)
        scores = np.asarray(ll.numpy(), np.float64)    # materialised
        order = np.argsort(-scores, kind="stable")     # ranked by numpy
        if not np.isfinite(scores).all():              # a Python branch on it
            raise FloatingPointError(f"non-finite scores {scores}")
        return scores, order, ops.getitem(logits, idx=(slice(None), -1))

    return core.function(step, **function_kw)


# --------------------------------------------------------------------------
# phase 2: the kernels against their plain versions
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


def paged_bound_ms(q, kp, valid, bs, window=0) -> float:
    """``portbench.roofline.bounds.paged_bound_ms`` (the ledger's
    ``kernel.paged_attention_roofline`` divides by it) at these inputs:
    q [B, 1, Hq, D], the arena kp [blocks, bs, Hkv, D], valid [B]."""
    _, _, Hq, D = q.shape
    return bounds.paged_bound_ms(valid.tolist(), Hq, kp.shape[2], D, bs,
                                 el=q.element_size(), window=window,
                                 dtype=str(q.dtype).replace("torch.", ""))


def sdpa_dense(q, kp, vp, bt, valid, window=0):
    """The library yardstick: scaled_dot_product_attention over K/V already
    gathered into dense [B, Hkv, S, D] rows, with the valid-length (and
    window) mask.  Returns a zero-argument callable (gather done outside
    it)."""
    import torch
    import torch.nn.functional as F
    B, _, Hq, D = q.shape
    Hkv = kp.shape[2]
    k = kp[bt.long()].reshape(B, -1, Hkv, D).transpose(1, 2).contiguous()
    v = vp[bt.long()].reshape(B, -1, Hkv, D).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()                   # [B, Hq, 1, D]
    pos = torch.arange(k.shape[2], device=q.device)
    ok = pos[None, :] < valid[:, None]
    if window:
        ok &= pos[None, :] >= valid[:, None] - window
    mask = ok[:, None, None, :]
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
    """paged_attention against ref_paged_attention over PAGED_SWEEP (each
    window of PAGED_WINDOWS), the serving shape and the longer cache, in
    f32 and bf16; timed at the serving shape in bf16 against the SDPA
    yardstick in turns, and (a logged line only) at the longer cache."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import (PAGED_LONG, PAGED_SERVING,
                                         PAGED_SWEEP, PAGED_WINDOWS,
                                         ref_paged_attention)
    cases = [(s, w) for s in PAGED_SWEEP for w in PAGED_WINDOWS]
    cases += [(PAGED_SERVING, 0), (PAGED_SERVING, 100), (PAGED_LONG, 0)]
    for i, (shape, window) in enumerate(cases):
        B, Hkv, G, D, bs, nbps, nblocks, valid = shape
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = paged_inputs(B, Hkv * G, Hkv, D, bs, nbps, nblocks, valid,
                                dtype, seed=i)
            out = PA.paged_attention(*args, window=window)
            ref = ref_paged_attention(*args, window=window)
            err, ok = close_err(out, ref, TOL[name])
            ok = ok and not bool(torch.isnan(out.float()).any())
            torch.cuda.synchronize()
            log(f"paged sweep B={B} Hkv={Hkv} G={G} D={D} bs={bs} "
                f"nbps={nbps} window={window} {name}: max_abs_err={err:.3e}"
                f" (tol {TOL[name]}), splits x blocks "
                f"{PA.split_plan(B, Hkv, nbps, bs)}")
            check(ok, f"paged_attention disagrees: {shape[:7]} window="
                  f"{window} {name} err={err}")
            if shape is PAGED_SERVING and window == 0 and name == "bfloat16":
                path_err = err

    row = None
    for shape in (PAGED_SERVING, PAGED_LONG):
        B, Hkv, G, D, bs, nbps, nblocks, valid = shape
        q, kp, vp, bt, vl = paged_inputs(B, Hkv * G, Hkv, D, bs, nbps,
                                         nblocks, valid, torch.bfloat16,
                                         seed=7)
        # rotating copies of the arena (together > the 50 MB L2): decode
        # reads each layer's arena cold; device time, since one call is
        # shorter than its host overhead
        rot = [(kp.clone(), vp.clone()) for _ in range(8 if nbps <= 32
                                                     else 4)]
        kernel = rotating([lambda k=k, v=v: PA.paged_attention(q, k, v, bt, vl)
                           for k, v in rot])
        lib = rotating([sdpa_dense(q, k, v, bt, vl) for k, v in rot])
        got, ms, lib_ms = turns(kernel, lib, 48)
        bound = paged_bound_ms(q, kp, vl, bs)
        label = (f"paged_attention bf16 B={B} Hq={Hkv * G} Hkv={Hkv} D={D} "
                 f"bs={bs} nbps={nbps} (max valid {max(valid)})")
        log(f"{label} turns (kernel, sdpa over gathered K/V) ms: "
            + ", ".join(f"({k:.5f}, {v:.5f})" for k, v in got))
        if row is None:
            plain_ms = time_ms(rotating([
                lambda k=k, v=v: ref_paged_attention(q, k, v, bt, vl)
                for k, v in rot]), 50)
            log(f"{label}: kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.5f} ms ({ms / lib_ms:.2f}x), bound {bound:.5f} ms "
                f"(bytes)")
            row = {"name": "paged_attention", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                   "replaces": "src/repro/kernels/paged_attention.py:75",
                   "launches": None, "max_abs_err": path_err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": "bytes", "library_ms": lib_ms}
        else:
            log(f"{label} (logged only): kernel {ms:.5f} ms, sdpa "
                f"{lib_ms:.5f} ms ({ms / lib_ms:.2f}x), bound {bound:.5f} ms "
                f"(bytes)")
        del rot, kernel, lib
    release()
    return row


def launch_counters():
    """Kernel name -> its wrapper, which carries the launch count."""
    from repro_torch.kernels import ops as kops
    return {"paged_attention": kops.paged_attention,
            "rmsnorm": kops.rmsnorm,
            "flash_attention": kops.flash_attention,
            "ssd_scan": kops.ssd_scan,
            "ssd_scan_bwd": kops.ssd_scan_bwd,
            "causal_conv": kops.causal_conv,
            "causal_conv_bwd": kops.causal_conv_bwd}


def zero_counts():
    for fn in launch_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in launch_counters().items()}


def close_err(out, ref, tol):
    """(max abs error, allclose at rtol = atol = tol) — the tolerance rule
    of the reference's kernel tests."""
    d = (out.float() - ref.float()).abs()
    ok = bool((d <= tol + tol * ref.float().abs()).all())
    return d.max().item(), ok


def seeded(shape, dtype, seed, scale=1.0):
    import numpy as np
    import torch
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(a).to("cuda", dtype)


def rms_view(shape, offset, dtype, seed):
    """Seeded x as a contiguous view starting ``offset`` elements into a
    fresh buffer on the card (offset 1: an unaligned x)."""
    import torch
    n = 1
    for v in shape:
        n *= v
    buf = torch.empty(offset + n, dtype=dtype, device="cuda")
    buf[offset:] = seeded((n,), dtype, seed)
    return buf[offset:].view(shape)


def rmsnorm_kernel_row(shape):
    """rmsnorm against ref_rmsnorm over RMS_SWEEP (both kernels of
    csrc/rmsnorm.cu: register-resident and generic) in f32 and bf16;
    timed at the main path's ``shape`` in bf16 (rotating copies of x,
    together > the L2) by device time, since one launch is shorter than
    its host overhead: kernel and F.rms_norm in three turns, then the
    register kernel's CTA shapes (threads a row x rows a CTA) in turns
    (logged)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import RMS_SWEEP, RMS_TOL, ref_rmsnorm
    RN = sys.modules["repro_torch.kernels.rmsnorm"]
    cases = list(RMS_SWEEP)
    if (tuple(shape), 0) not in cases:
        cases.append((tuple(shape), 0))
    for shp, offset in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            x = rms_view(shp, offset, dtype, 2)
            g = seeded(shp[-1:], dtype, 3, 0.1)
            err, ok = close_err(kops.rmsnorm(x, g), ref_rmsnorm(x, g),
                                RMS_TOL[name])
            torch.cuda.synchronize()
            plan = RN.launch_plan(shp[-1], x.element_size(), offset == 0)
            log(f"rmsnorm {shp} offset {offset} {name}: max_abs_err="
                f"{err:.3e} (tol {RMS_TOL[name]}), plan (vec, threads, "
                f"packs) {plan}")
            check(ok, f"rmsnorm disagrees at {shp} offset {offset} {name}: "
                  f"err={err}")
            if tuple(shp) == tuple(shape) and dtype == torch.bfloat16:
                path_err = err
    d = shape[-1]
    xs = [seeded(shape, torch.bfloat16, 10 + i) for i in range(8)]
    g = seeded((d,), torch.bfloat16, 3, 0.1)
    w = 1.0 + g                            # the library call's weight
    kernel = rotating([lambda x=x: kops.rmsnorm(x, g) for x in xs])
    lib = rotating([lambda x=x: F.rms_norm(x, (d,), weight=w, eps=1e-6)
                    for x in xs])
    plain_ms = device_ms(rotating([lambda x=x: ref_rmsnorm(x, g)
                                   for x in xs]), 48)
    got, ms, lib_ms = turns(kernel, lib, 48)
    log("rmsnorm turns (kernel, F.rms_norm) ms: "
        + ", ".join(f"({k:.5f}, {v:.5f})" for k, v in got))
    nbytes = 2 * xs[0].numel() * 2 + d * 2  # x read, out written, g read
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                      4 * xs[0].numel() / OPS_PER_S["bfloat16"])
    log(f"rmsnorm bf16 {shape} device time: kernel {ms:.5f} ms "
        f"({ms / lib_ms:.3f}x F.rms_norm, {bound / ms:.1%} of the HBM rate),"
        f" plain {plain_ms:.4f} ms, F.rms_norm {lib_ms:.5f} ms, bound "
        f"{bound:.5f} ms (bytes); plan {RN.launch_plan(d, 2, True)}")
    del xs, kernel, lib
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:16",
            "launches": None, "max_abs_err": path_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_ms}


def attn_pairs(Sq, Skv, causal, window) -> int:
    """Unmasked (query, key) pairs of one head: the work these inputs need."""
    import numpy as np
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= kp > qp - window
    return int(ok.sum())


def attn_bound_ms(q, k, causal, window=0):
    """q/k/v read once, the output written once; 4·D operations (QK and
    PV) per unmasked pair, at the tensor-core peak of the inputs' type."""
    B, H, Sq, D = q.shape
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * k.numel() * el
    ops = 4 * D * B * H * attn_pairs(Sq, k.shape[2], causal, window)
    dt = str(q.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[dt]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def flash_kernel_row(bh, seq):
    """flash_attention against ref_attention over ATTN_SWEEP and
    CARD_ONLY_ATTN and the main path's shape (``bh`` heads of one (b, h)
    each, as kernel.attention hands them over, ``seq`` tokens, D = 128,
    causal); timed there in bf16 against SDPA in turns by device time over
    rotating copies of q/k/v, and once more at 1024 tokens."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import (ATTN_SWEEP, CARD_ONLY_ATTN,
                                         ref_attention)
    path = (bh, 1, 1, seq, seq, 128, True, 0)
    for case in ATTN_SWEEP + CARD_ONLY_ATTN + [path]:
        B, H, Hkv, Sq, Skv, D, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q = seeded((B, H, Sq, D), dtype, 0)
            k = seeded((B, Hkv, Skv, D), dtype, 1)
            v = seeded((B, Hkv, Skv, D), dtype, 2)
            out = kops.flash_attention(q, k, v, causal=causal, window=window)
            ref = ref_attention(q, k, v, causal=causal, window=window)
            err, ok = close_err(out, ref, TOL[name])
            torch.cuda.synchronize()
            log(f"flash_attention {case} {name}: max_abs_err={err:.3e} "
                f"(tol {TOL[name]})")
            check(ok, f"flash_attention disagrees at {case} {name}: "
                  f"err={err}")
            del out, ref, q, k, v
    row = None
    for S in (seq, 1024):
        qkv = [[seeded((bh, 1, S, 128), torch.bfloat16, 20 + 3 * i + j)
                for j in range(3)] for i in range(4)]
        kernel = rotating([lambda t=t: kops.flash_attention(*t) for t in qkv])
        lib = rotating([
            lambda t=t: F.scaled_dot_product_attention(*t, is_causal=True)
            for t in qkv])
        got, ms, lib_ms = turns(kernel, lib, 20)
        bound, by = attn_bound_ms(qkv[0][0], qkv[0][1], True)
        log(f"flash_attention bf16 [{bh},1,{S},128] causal turns (kernel, "
            f"sdpa) ms: " + ", ".join(f"({k:.5f}, {v:.5f})" for k, v in got))
        if row is None:
            plain_ms = time_ms(rotating([lambda t=t: ref_attention(*t)
                                         for t in qkv]), 5)
            row = {"name": "flash_attention", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention.py:26",
                   "launches": None, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": lib_ms}
        log(f"flash_attention bf16 [{bh},1,{S},128] causal: kernel "
            f"{ms:.5f} ms, "
            + (f"plain {plain_ms:.4f} ms, " if S == seq else "")
            + f"sdpa {lib_ms:.5f} ms ({ms / lib_ms:.2f}x), bound "
            f"{bound:.5f} ms ({by})")
        del qkv, kernel, lib
    release()
    return row


# the paged decode shapes of this slice's families (phase 2): 8 rows in
# 16-token pages; mixtral's rows run past its 4096 window, recurrentgemma's
# past its 2048 one
PAGED_FAMILIES = {
    # arch: (B, Hkv, G, D, bs, nbps, window, valid)
    "deepseek-moe-16b": (8, 16, 1, 128, 16, 32, 0,
                         [1, 17, 100, 255, 256, 300, 444, 512]),
    "qwen2.5-14b": (8, 8, 5, 128, 16, 32, 0,
                    [1, 17, 100, 255, 256, 300, 444, 512]),
    "mixtral-8x22b": (8, 8, 6, 128, 16, 384, 4096,
                      [1, 700, 2000, 4095, 4097, 5000, 6000, 6144]),
    "recurrentgemma-2b": (8, 1, 10, 256, 16, 192, 2048,
                          [1, 300, 1024, 2048, 2049, 2500, 3000, 3072]),
}


def family_paged_rows():
    """paged_attention at each family's decode shape: against its plain
    version in f32 and bf16, then timed in bf16 (rotating arena copies
    together > the L2) against SDPA over gathered K/V in turns by device
    time, beside the plain version's time and the bound."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import ref_paged_attention
    rows = []
    for arch, shape in PAGED_FAMILIES.items():
        B, Hkv, G, D, bs, nbps, window, valid = shape
        nblocks = sum(-(-v // bs) for v in valid) + 1
        label = (f"paged_attention {arch} B={B} Hq={Hkv * G} Hkv={Hkv} "
                 f"D={D} window={window} (max valid {max(valid)})")
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = paged_inputs(B, Hkv * G, Hkv, D, bs, nbps, nblocks, valid,
                                dtype, seed=11)
            out = PA.paged_attention(*args, window=window)
            ref = ref_paged_attention(*args, window=window)
            err, ok = close_err(out, ref, TOL[name])
            ok = ok and not bool(torch.isnan(out.float()).any())
            torch.cuda.synchronize()
            errs[name] = err
            log(f"{label} {name}: max_abs_err={err:.3e} (tol {TOL[name]}), "
                f"group {PA.padded_group(G)}, splits x blocks "
                f"{PA.split_plan(B, Hkv, nbps, bs)}")
            check(ok, f"paged_attention disagrees at {arch}'s shape {name}:"
                  f" err={err}")
            del args, out, ref
        q, kp, vp, bt, vl = paged_inputs(B, Hkv * G, Hkv, D, bs, nbps,
                                         nblocks, valid, torch.bfloat16,
                                         seed=7)
        n_rot = min(8, max(2, -(-100 * 2**20 // (2 * kp.numel() * 2))))
        rot = [(kp.clone(), vp.clone()) for _ in range(n_rot)]
        kernel = rotating([
            lambda k=k, v=v: PA.paged_attention(q, k, v, bt, vl,
                                                window=window)
            for k, v in rot])
        lib = rotating([sdpa_dense(q, k, v, bt, vl, window)
                        for k, v in rot])
        got, ms, lib_ms = turns(kernel, lib, 48)
        plain_ms = time_ms(rotating([
            lambda k=k, v=v: ref_paged_attention(q, k, v, bt, vl,
                                                 window=window)
            for k, v in rot]), 20)
        bound = paged_bound_ms(q, kp, vl, bs, window)
        _, split = device_split(kernel, 48)
        log(f"{label} turns (kernel, sdpa over gathered K/V) ms: "
            + ", ".join(f"({k:.5f}, {v:.5f})" for k, v in got)
            + f"; device ms by kernel {json.dumps(split)}")
        log(f"{label}: kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.5f} ms ({ms / lib_ms:.2f}x), bound {bound:.5f} ms "
            f"(bytes)")
        rows.append({"name": f"paged_attention[{arch}]", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "paged_attention.cu",
                     "replaces": "src/repro/kernels/paged_attention.py:75",
                     "launches": None, "max_abs_err": errs["bfloat16"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": lib_ms})
        del q, kp, vp, bt, vl, rot, kernel, lib
        release()
    return rows


FLASH_D256 = (4, 10, 1, 256, 2048)      # B, H, Hkv, D, window (causal)
# kernel rows whose shape no main path of this run launches, and why
OFF_PATH = {"flash_attention[recurrentgemma-2b]":
            "no main path of this run has flash at D = 256 (only the "
            "op-level scoring program reaches flash, and it is llama's)"}


def flash_d256_row():
    """flash_attention at recurrentgemma-2b's heads (10/1 x 256, causal,
    window 2048) at 512 and 4096 tokens: against its plain version in f32
    and bf16, timed in bf16 against SDPA with the same mask in turns (the
    row: 4096 tokens, where the window bites)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import ref_attention
    B, H, Hkv, D, window = FLASH_D256
    row = None
    for S in (512, 4096):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q = seeded((B, H, S, D), dtype, 30)
            k = seeded((B, Hkv, S, D), dtype, 31)
            v = seeded((B, Hkv, S, D), dtype, 32)
            out = kops.flash_attention(q, k, v, causal=True, window=window)
            ref = ref_attention(q, k, v, causal=True, window=window)
            err, ok = close_err(out, ref, TOL[name])
            torch.cuda.synchronize()
            errs[name] = err
            log(f"flash_attention D=256 [{B},{H}/{Hkv},{S},{D}] causal "
                f"window {window} {name}: max_abs_err={err:.3e} (tol "
                f"{TOL[name]})")
            check(ok, f"flash_attention disagrees at D=256 S={S} {name}: "
                  f"err={err}")
            del q, k, v, out, ref
        pos = torch.arange(S, device="cuda")
        mask = ((pos[:, None] >= pos[None, :])
                & (pos[None, :] > pos[:, None] - window))
        qkv = [[seeded((B, H if j == 0 else Hkv, S, D), torch.bfloat16,
                       40 + 3 * i + j) for j in range(3)] for i in range(4)]
        kernel = rotating([lambda t=t: kops.flash_attention(
            *t, causal=True, window=window) for t in qkv])
        lib = rotating([lambda t=t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, enable_gqa=True) for t in qkv])
        got, ms, lib_ms = turns(kernel, lib, 10)
        plain_ms = time_ms(rotating([lambda t=t: ref_attention(
            *t, causal=True, window=window) for t in qkv]), 3)
        bound, by = attn_bound_ms(qkv[0][0], qkv[0][1], True, window)
        log(f"flash_attention bf16 D=256 [{B},{H}/{Hkv},{S},{D}] turns "
            f"(kernel, sdpa) ms: "
            + ", ".join(f"({a:.5f}, {b:.5f})" for a, b in got))
        log(f"flash_attention bf16 D=256 S={S}: kernel {ms:.5f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.5f} ms ({ms / lib_ms:.2f}x),"
            f" bound {bound:.5f} ms ({by})")
        row = {"name": "flash_attention[recurrentgemma-2b]", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:26",
               "launches": None, "max_abs_err": errs["bfloat16"], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": lib_ms}
        del qkv, kernel, lib, mask
        release()
    return row


# whisper-small's two unmasked attentions as kernel.attention hands them
# to the flash wrapper ([B*H, 1, S, D]: 4 audio x 12 heads, 64 wide) on
# the scoring program's path (phase cross): (name, Sq, Skv)
WHISPER_FLASH = (("encoder", 1500, 1500), ("cross", 128, 1500))
WHISPER_BH = 4 * 12


def flash_whisper_rows():
    """flash_attention at whisper-small's encoder (1500 x 1500) and cross
    (128 queries x 1500 keys) shapes, no mask: against its plain version
    in f32 and bf16, then timed in bf16 against SDPA with no mask (so
    that SDPA takes its flash path) in three turns by device time, over
    rotating copies of q/k/v, beside the plain version's time and the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import ref_attention
    rows = []
    for name, Sq, Skv in WHISPER_FLASH:
        errs = {}
        label = f"flash_attention whisper {name} [{WHISPER_BH},1,{Sq}|{Skv},64]"
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).replace("torch.", "")
            q = seeded((WHISPER_BH, 1, Sq, 64), dtype, 50)
            k = seeded((WHISPER_BH, 1, Skv, 64), dtype, 51)
            v = seeded((WHISPER_BH, 1, Skv, 64), dtype, 52)
            out = kops.flash_attention(q, k, v, causal=False)
            ref = ref_attention(q, k, v, causal=False)
            err, ok = close_err(out, ref, TOL[dn])
            torch.cuda.synchronize()
            errs[dn] = err
            log(f"{label} {dn}: max_abs_err={err:.3e} (tol {TOL[dn]})")
            check(ok, f"flash_attention disagrees at whisper's {name} shape "
                  f"{dn}: err={err}")
            del q, k, v, out, ref
        qkv = [[seeded((WHISPER_BH, 1, Sq if j == 0 else Skv, 64),
                       torch.bfloat16, 60 + 3 * i + j) for j in range(3)]
               for i in range(4)]
        kernel = rotating([lambda t=t: kops.flash_attention(*t, causal=False)
                           for t in qkv])
        lib = rotating([lambda t=t: F.scaled_dot_product_attention(*t)
                        for t in qkv])
        got, ms, lib_ms = turns(kernel, lib, 20)
        plain_ms = time_ms(rotating([lambda t=t: ref_attention(
            *t, causal=False) for t in qkv]), 5)
        bound, by = attn_bound_ms(qkv[0][0], qkv[0][1], False)
        log(f"{label} bf16 turns (kernel, sdpa) ms: "
            + ", ".join(f"({a:.5f}, {b:.5f})" for a, b in got))
        log(f"{label} bf16: kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.5f} ms ({ms / lib_ms:.2f}x), bound {bound:.5f} "
            f"ms ({by})")
        rows.append({"name": f"flash_attention[whisper-small {name}]",
                     "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:26",
                     "launches": None, "max_abs_err": errs["bfloat16"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib_ms})
        del qkv, kernel, lib
        release()
    return rows


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
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["paged_attention"]
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
    log(f"serving launches: {json.dumps(counts)}")
    kernel_rows[0]["launches"] = launches
    del sched, params
    release()


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
    release()


# --------------------------------------------------------------------------
# phases 5 and 6: the imperative scoring program through function()
# --------------------------------------------------------------------------

SCORE_BATCH, SCORE_SEQ = 4, 512
SCORE_CALLS = 10                 # calls of the kernel program in phase 5


def score_tokens(cfg, i):
    import numpy as np
    return np.random.RandomState(1000 + i).randint(
        0, cfg.vocab, (SCORE_BATCH, SCORE_SEQ)).astype(np.int32)


def score_call(step, cfg, i):
    """One call of the scoring program; the next-token logits are fetched
    in every call, so every call has the same fetches."""
    import numpy as np
    scores, order, last = step(score_tokens(cfg, i))
    last = last.numpy()
    check(scores.shape == (SCORE_BATCH,) and np.isfinite(scores).all()
          and (scores < 0).all(), f"bad scores {scores}")
    check(last.shape == (SCORE_BATCH, cfg.vocab) and np.isfinite(last).all(),
          f"bad next-token logits {last.shape}")
    check(sorted(order.tolist()) == list(range(SCORE_BATCH)),
          f"bad ranking {order}")
    return scores


def phase_coexec_kernels(rows):
    import torch
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("llama3-8b")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    n_rms, n_attn = 2 * cfg.n_layers + 1, cfg.n_layers
    # the default optimize ("all") adds the kernels pass on the card
    step = llama_score_program(core, cfg, params, SCORE_BATCH, SCORE_SEQ)
    peak = {"traced": 0, "compiled": 0}
    # counts of this path only: zeroed just before it, read just after
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SCORE_CALLS):
        traced = step.stats.get("traced_iterations", 0)
        torch.cuda.reset_peak_memory_stats()
        score_call(step, cfg, i)
        step.wait()
        kind = ("traced" if step.stats["traced_iterations"] > traced
                else "compiled")
        peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = step.stats
    compiled = st["iterations"] - st["traced_iterations"]
    keys = ("iterations", "traced_iterations", "retraces", "replays",
            "graph_versions", "kernels_substituted", "feeds_folded",
            "nodes_eliminated", "cse_hits", "segments_dispatched",
            "steady_iters")
    log("coexec-kernels counters: " + json.dumps(
        {k: st.get(k) for k in keys} | {"phase": step.phase}))
    log(f"coexec-kernels launches: {json.dumps(counts)}; {SCORE_CALLS} "
        f"calls of {SCORE_BATCH}x{SCORE_SEQ} tokens in {wall:.2f} s (bring-up "
        f"reading, includes tracing); peak device memory "
        f"{peak['traced'] / 2**30:.1f} GiB in a traced call, "
        f"{peak['compiled'] / 2**30:.1f} GiB in a compiled call")
    check(step.phase == "co-execution", f"phase {step.phase}")
    check(st["kernels_substituted"] >= n_rms + n_attn,
          f"kernels_substituted {st['kernels_substituted']} < "
          f"{n_rms + n_attn}")
    check(compiled > 0, "no call ran the compiled graph")
    # traced calls run the unfused ops eagerly; each compiled call runs
    # every rms_norm and attention node through its kernel
    check(counts["rmsnorm"] == compiled * n_rms,
          f"rmsnorm launches {counts['rmsnorm']} != {compiled} compiled "
          f"calls x {n_rms}")
    check(counts["flash_attention"] == compiled * n_attn,
          f"flash_attention launches {counts['flash_attention']} != "
          f"{compiled} compiled calls x {n_attn}")
    rows[1]["launches"] = counts["rmsnorm"]
    rows[2]["launches"] = counts["flash_attention"]

    # bring-up reading: unfused program against kernel program, in turns
    unfused = llama_score_program(core, cfg, params, SCORE_BATCH, SCORE_SEQ,
                                  optimize="safe")
    arms = {"kernel": step, "unfused": unfused}
    for i in range(3):                    # tracing + co-execution entry
        score_call(unfused, cfg, i)
    turn_scores = []
    for name in ("unfused", "kernel", "kernel", "unfused"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [score_call(arms[name], cfg, 100 + i) for i in range(5)]
        arms[name].wait()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        turn_scores.append(got)
        log(f"coexec turn {name}: {ms:.1f} ms per call "
            f"({SCORE_BATCH * SCORE_SEQ / ms * 1e3:.0f} tokens/s)")
    diff = max(abs(a - b).max()
               for a, b in zip(turn_scores[0], turn_scores[1]))
    log(f"coexec bf16 scores, kernel vs unfused: max abs diff {diff:.3e} "
        f"(bf16 rounding differs between the arms, and the flash kernel "
        f"rounds P to bf16 before P.V; phase 6 checks f32)")
    check(unfused.phase == "co-execution", f"unfused phase {unfused.phase}")
    for fn in arms.values():
        fn.close()
    del step, unfused, arms, params
    release()


def phase_coexec_equality():
    import repro_torch.core as core
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=4,
                              dtype="float32", param_dtype="float32")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(1))
    arms = {"kernel": llama_score_program(core, cfg, params, SCORE_BATCH,
                                          SCORE_SEQ),
            "unfused": llama_score_program(core, cfg, params, SCORE_BATCH,
                                           SCORE_SEQ, optimize="safe")}
    outs = {}
    for name, step in arms.items():
        before = read_counts()
        outs[name] = [score_call(step, cfg, i) for i in range(5)]
        step.wait()
        after = read_counts()
        log(f"coexec-equality arm {name}: phase {step.phase}, "
            f"kernels_substituted {step.stats.get('kernels_substituted')}, "
            f"launches rmsnorm {after['rmsnorm'] - before['rmsnorm']}, "
            f"flash_attention "
            f"{after['flash_attention'] - before['flash_attention']}")
        check(step.phase == "co-execution", f"{name} phase {step.phase}")
        if name == "kernel":
            check(after["flash_attention"] > before["flash_attention"]
                  and after["rmsnorm"] > before["rmsnorm"],
                  "the kernel arm launched no kernel")
        step.close()
    worst = 0.0
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["unfused"])):
        d = abs(a - b)
        worst = max(worst, float(d.max()))
        if (d > 1e-4).any():
            j = int(d.argmax())
            raise SmokeFailure(
                f"float32 scores differ at call {i}, sequence {j}: kernel "
                f"{a[j]!r} vs unfused {b[j]!r}")
    log(f"coexec-equality: float32 scores of the kernel and the unfused "
        f"program agree on all 5 calls (max abs diff {worst:.3e} <= 1e-4)")
    del arms, params
    release()


# --------------------------------------------------------------------------
# the SSD-scan kernel (phase 2) and mamba2-130m (phases 7 and 8)
# --------------------------------------------------------------------------

# the main path's two shapes at mamba2-130m's widths: one request's
# prefill (with the final state) and the eval forward
SSD_PATH = {"prefill": (1, 1024, True), "forward": (4, 2048, False)}
MAMBA_H, MAMBA_P, MAMBA_N, MAMBA_CHUNK = 24, 64, 128, 256


def ssd_inputs(B, S, H, P, N, dtype, seed, dt_dtype, strided):
    """x, dt, A, Bm, Cm on the card, the reference test's distributions
    (dt = softplus(randn) * 0.1, A = -exp(randn * 0.3)).  ``strided``: x,
    Bm and Cm are slices of one [B, S, H*P + 2N] buffer, as mamba2_block
    hands them over, and dt a slice of a wider buffer."""
    import numpy as np
    import torch
    r = np.random.RandomState(seed)
    d_inner = H * P
    conv = torch.from_numpy(r.randn(B, S, d_inner + 2 * N).astype(
        np.float32)).to("cuda", dtype)
    dtw = torch.from_numpy((np.log1p(np.exp(r.randn(B, S, H + 3))) * 0.1)
                           .astype(np.float32)).to("cuda", dt_dtype)
    A = torch.from_numpy((-np.exp(r.randn(H) * 0.3)).astype(
        np.float32)).to("cuda")
    x = conv[..., :d_inner].reshape(B, S, H, P)
    Bm, Cm = conv[..., d_inner:d_inner + N], conv[..., d_inner + N:]
    dt = dtw[..., 3:]
    if not strided:
        x, dt, Bm, Cm = (t.contiguous() for t in (x, dt, Bm, Cm))
    return x, dt, A, Bm, Cm


# the SSD bounds stay the script's own: they follow kernels/ssd_scan.CHUNK,
# where portbench.roofline.bounds freezes the chunk at 64
def ssd_pairs(S):
    """The causal (i >= j) token pairs of the kernels' chunks over S
    tokens: the intra-chunk products' work, a ragged last chunk counted
    at its own length."""
    Q = sys.modules["repro_torch.kernels.ssd_scan"].CHUNK
    r = S % Q
    return S // Q * Q * (Q + 1) // 2 + r * (r + 1) // 2


def ssd_bound_ms(x, dt, Bm, final):
    """Each input read once, y (and the final state) written once; the
    work over the causal pairs of the kernels' chunks (ssd_pairs), at
    the peak of x's type: per pair C·Bᵀ (N, shared by the heads, as B
    and C are) and per head M·(dt·x) (P), per token and head C·hᵀ and the
    state update (P·N each), two operations per multiply-add."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    el, del_ = x.element_size(), dt.element_size()
    nbytes = (2 * B * S * H * P * el + 2 * B * S * N * el + B * S * H * del_
              + H * 4 + (B * H * P * N * 4 if final else 0))
    ops = 2 * B * (ssd_pairs(S) * (N + H * P) + S * H * 2 * P * N)
    dtn = str(x.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[dtn]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def ssd_kernel_row():
    """ssd_scan against ref_ssd (the sequential recurrence), the port's
    plain chunked math (models/ssm.ssd_chunked_plain, called directly on
    the card as the yardstick) and the kernels' own decomposition
    (ref.ssd_chunk_parallel, with the bf16 kernels' operand rounding) over
    SSD_SWEEP and the path's shapes, in f32 and bf16, with and without
    the final state, contiguous and strided; timed at both path shapes in
    bf16 over rotating strided inputs (together > the L2): CUDA-event time
    per call and the profiler's device time summed over the call's
    kernels, split per kernel, in three turns, with the scratch bytes.  No
    single PyTorch call computes the SSD scan, so the row has no library
    time."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import (SSD_SWEEP, SSD_TOL, ref_ssd,
                                         ssd_chunk_parallel)
    from repro_torch.models.ssm import ssd_chunked_plain
    SS = sys.modules["repro_torch.kernels.ssd_scan"]

    def compare(label, args, chunk, final, strided, tol):
        out = kops.ssd_scan(*args, chunk=chunk, return_final=final)
        y, h = out if final else (out, None)
        ry, rh = ref_ssd(*args, return_final=True)
        cy = ssd_chunked_plain(*args, chunk, return_final=final)
        cy, ch = cy if final else (cy, None)
        ey, eh = ssd_chunk_parallel(
            *args, chunk=SS.CHUNK, return_final=True,
            round_bf16=args[0].dtype == torch.bfloat16)
        torch.cuda.synchronize()
        pairs = [("ref_ssd", y, ry), ("chunked", y, cy), ("emulation", y, ey)]
        if final:
            pairs += [("ref_ssd h", h, rh), ("chunked h", h, ch),
                      ("emulation h", h, eh)]
        errs = {}
        for name, a, b in pairs:
            err, ok = close_err(a, b, tol)
            errs[name] = err
            check(ok and not bool(torch.isnan(a.float()).any()),
                  f"ssd_scan disagrees with {name} at {label}: err={err}")
        log(f"ssd_scan {label} final={final} strided={strided}: "
            "max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {tol})")
        return max(errs.values())

    for i, case in enumerate(SSD_SWEEP):
        B, S, H, P, N, ref_chunk = case
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            for final in (False, True):
                args = ssd_inputs(B, S, H, P, N, dtype, i, torch.float32,
                                  strided=final)
                compare(f"{case} {name}", args, ref_chunk, final, final,
                        SSD_TOL[name])
    err = None
    for j, (shape, (B, S, final)) in enumerate(SSD_PATH.items()):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            # the model hands over bf16 dt in a bf16 model
            args = ssd_inputs(B, S, MAMBA_H, MAMBA_P, MAMBA_N, dtype, 50 + j,
                              dtype, strided=True)
            e = compare(f"{shape} [{B},{S},{MAMBA_H},{MAMBA_P}] N={MAMBA_N} "
                        f"{name}", args, MAMBA_CHUNK, final, True,
                        SSD_TOL[name])
            if shape == "prefill" and dtype == torch.bfloat16:
                err = e
            del args
    row = None
    for shape, (B, S, final) in SSD_PATH.items():
        ins = [ssd_inputs(B, S, MAMBA_H, MAMBA_P, MAMBA_N, torch.bfloat16,
                          100 + i, torch.bfloat16, strided=True)
               for i in range(16 if B == 1 else 4)]
        call = rotating([
            lambda t=t: kops.ssd_scan(*t, chunk=MAMBA_CHUNK,
                                      return_final=final) for t in ins])
        runs = [(time_ms(call, 40),) + device_split(call, 40)
                for _ in range(3)]
        scratch = SS.scratch_bytes(B, S, MAMBA_H, MAMBA_P, MAMBA_N, final,
                                   torch.bfloat16)
        log(f"ssd_scan bf16 {shape} [{B},{S},{MAMBA_H},{MAMBA_P}] "
            f"N={MAMBA_N} final={final} (chunks, heads a CTA "
            f"{SS.plan(B, S, MAMBA_H)}, scratch {scratch / 1e6:.2f} MB): "
            "turns (events ms, device ms) "
            + ", ".join(f"({e:.5f}, {d:.5f})" for e, d, _ in runs)
            + "; per kernel " + "; ".join(
                f"{k} {v:.5f}" for k, v in runs[-1][2].items()))
        ms = sorted(d for _, d, _ in runs)[1]                # medians
        ev_ms = sorted(e for e, _, _ in runs)[1]
        plain_ms = time_ms(rotating([
            lambda t=t: ssd_chunked_plain(*t, MAMBA_CHUNK,
                                          return_final=final)
            for t in ins]), 8)
        bound, by = ssd_bound_ms(ins[0][0], ins[0][1], ins[0][3], final)
        log(f"ssd_scan bf16 {shape} [{B},{S},{MAMBA_H},{MAMBA_P}] "
            f"N={MAMBA_N} final={final}: kernels {ms:.5f} ms "
            f"device time (events {ev_ms:.5f} ms), {ms / bound:.1f}x the "
            f"bound {bound:.5f} ms ({by}); plain {plain_ms:.4f} ms; no "
            f"PyTorch library call computes the SSD scan")
        if row is None:
            row = {"name": "ssd_scan", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                   "replaces": "src/repro/kernels/ssd_scan.py:21",
                   "launches": None, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": None}
        del ins
    release()
    return row


# of the largest value: against all-plain autograd, and against
# ref_ssd_bwd (the same passes in f32: only the kernel's bf16 hi + lo
# operands and bf16 outputs differ)
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SSD_BWD_REF_TOL = {"float32": 1e-4, "bfloat16": 1.5e-2}
# bf16 against ref_ssd_bwd(..., round_bf16=True), the emulation of the
# kernel's rounding points on the inputs in f32: half a bf16 step of the
# largest value (2^-8) from the outputs' rounding, plus the order of f32
# sums
SSD_BWD_EMU_TOL = 5e-3
SSD_BWD_NAME = "ssd_scan_bwd[mamba2 training 8x2048]"
# (label, B, S, dh_final): the serving prefill (with the final state's
# cotangent), the launcher's training shape and a ragged length
SSD_BWD_PATH = (("prefill", 1, 1024, True), ("training", 8, 2048, False),
                ("training+dh", 8, 2048, True), ("ragged", 2, 1000, True))


def ssd_bwd_bound_ms(x, dt, Bm, final):
    """x, dt, B, C and dy read once (and dh_final), their gradients and dA
    written once; the gradient's work over the causal pairs of the
    kernels' chunks (ssd_pairs), at the peak of x's type: per pair C·Bᵀ
    (N, shared by the heads) and per head dy·uᵀ and Mᵀ·dy (P each) and
    the intra-chunk dB and dC (N each), per token and head five [P, N]
    products (the chunk state recomputed, its gradient g, D·B, dyᵀ·h and
    uᵀ·D), two operations per multiply-add."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    el, del_ = x.element_size(), dt.element_size()
    nbytes = (3 * B * S * H * P * el + 4 * B * S * N * el + 2 * B * S * H
              * del_ + 2 * H * 4 + (B * H * P * N * 4 if final else 0))
    ops = 2 * B * (ssd_pairs(S) * (N + H * (2 * P + 2 * N))
                   + S * H * 5 * P * N)
    dtn = str(x.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[dtn]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def plain_ssd_grads(args, dy, dh, chunk):
    """All-plain autograd of ssd_chunked_plain for the cotangents dy (and
    dh): the path SSDScan's backward took before its kernel."""
    import torch
    from repro_torch.models.ssm import ssd_chunked_plain
    ps = [a.detach().requires_grad_(True) for a in args]
    out = ssd_chunked_plain(*ps, chunk, return_final=dh is not None)
    outs, gs = ((out,), (dy,)) if dh is None else (out, (dy, dh))
    return torch.autograd.grad(outs, ps, gs)


def grad_errs(got, want):
    """Max abs error and max error relative to the largest value, per
    gradient (dx, ddt, dA, dB, dC)."""
    out = []
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        out.append((err, err / max(w.float().abs().max().item(), 1e-30)))
    return out


def ssd_bwd_kernel_row():
    """ssd_scan_bwd (the SSD scan's gradient) against ref.ref_ssd_bwd (its
    own decomposition in plain torch) over SSD_SWEEP (each case with
    dh_final in one dtype and without in the other) and SSD_BWD_PATH (the
    serving prefill, the launcher's training shape [8, 2048] with the
    model's strided conv-slice inputs, a ragged length), and at
    SSD_BWD_PATH also against all-plain autograd of ssd_chunked_plain, f32
    and bf16: every gradient within SSD_BWD_REF_TOL (SSD_BWD_TOL against
    plain autograd) of its largest value, bf16 also within SSD_BWD_EMU_TOL
    of ref_ssd_bwd(..., round_bf16=True) (the emulation of its rounding
    points), no NaN, and a second call equal to the bit.  Then timed at
    the training shape in bf16 over rotating inputs (together > the L2):
    CUDA events a call in three turns (the median) and the profiler's
    device time split per kernel, its sum beside the event time (flagged
    when it covers less than 90 % of it: the profiler drops events at
    some shapes), beside the plain backward (autograd of ssd_chunked_plain
    with its forward recompute, the path the kernel replaces) and the
    bound; the kernels' registers and spills from the build log, and the
    gradient pass's shared memory a CTA and CTAs a SM as the card reports
    them (ssd_scan.grad_occupancy).  No PyTorch call computes the SSD
    scan's gradient.  The row's launches come from phase launch."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import SSD_SWEEP, ref_ssd_bwd
    SS = sys.modules["repro_torch.kernels.ssd_scan"]

    def compare(label, args, dy, dh, chunk=None):
        got = kops.ssd_scan_bwd(*args, dy, dh)
        again = kops.ssd_scan_bwd(*args, dy, dh)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(g, a) for g, a in zip(got, again))
        name = str(args[0].dtype).replace("torch.", "")
        tols = {"ref_ssd_bwd": SSD_BWD_REF_TOL[name]}
        errs = {"ref_ssd_bwd": grad_errs(got, ref_ssd_bwd(*args, dy, dh))}
        if name == "bfloat16":
            tols["emulation"] = SSD_BWD_EMU_TOL
            errs["emulation"] = grad_errs(got, ref_ssd_bwd(
                *(a.float() for a in args), dy.float(), dh,
                round_bf16=True))
        if chunk is not None:
            tols["plain autograd"] = SSD_BWD_TOL[name]
            errs["plain autograd"] = grad_errs(got, plain_ssd_grads(
                args, dy, dh, chunk))
        nan = any(bool(torch.isnan(g.float()).any()) for g in got)
        log(f"ssd_scan_bwd {label} {name} dh_final={dh is not None}: "
            f"bitwise repeat {bitwise}; max rel err (dx, ddt, dA, dB, dC) "
            + "; ".join(f"vs {k} " + " ".join(f"{r:.2e}" for _, r in v)
                        + f" (tol {tols[k]})" for k, v in errs.items()))
        for k, v in errs.items():
            check(all(r <= tols[k] for _, r in v) and not nan,
                  f"ssd_scan_bwd disagrees with {k} at {label} {name}: {v}")
        check(bitwise, f"ssd_scan_bwd is not bitwise repeatable at {label}")
        return max(e for v in errs.values() for e, _ in v)

    for i, case in enumerate(SSD_SWEEP):
        B, S, H, P, N, _ = case
        for k, dtype in enumerate((torch.float32, torch.bfloat16)):
            final = (i + k) % 2 == 1        # each case both ways, by dtype
            args = ssd_inputs(B, S, H, P, N, dtype, 300 + i, torch.float32,
                              strided=final)
            dy = seeded((B, S, H, P), dtype, 400 + i)
            dh = seeded((B, H, P, N), torch.float32, 500 + i) \
                if final else None
            compare(str(case), args, dy, dh)
    err = None
    for j, (label, B, S, final) in enumerate(SSD_BWD_PATH):
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(B, S, MAMBA_H, MAMBA_P, MAMBA_N, dtype, 600 + j,
                              dtype, strided=True)
            dy = seeded((B, S, MAMBA_H, MAMBA_P), dtype, 610 + j)
            dh = seeded((B, MAMBA_H, MAMBA_P, MAMBA_N), torch.float32,
                        620 + j) if final else None
            e = compare(f"{label} [{B},{S},{MAMBA_H},{MAMBA_P}] "
                        f"N={MAMBA_N}", args, dy, dh, MAMBA_CHUNK)
            if label == "training" and dtype == torch.bfloat16:
                err = e
            del args, dy, dh
            release()

    B, S = SSD_TRAIN
    ins = [ssd_inputs(B, S, MAMBA_H, MAMBA_P, MAMBA_N, torch.bfloat16,
                      700 + i, torch.bfloat16, strided=True)
           + (seeded((B, S, MAMBA_H, MAMBA_P), torch.bfloat16, 710 + i),)
           for i in range(2)]
    call = rotating([lambda t=t: kops.ssd_scan_bwd(*t) for t in ins])
    runs = [time_ms(call, 10) for _ in range(3)]
    ms = sorted(runs)[1]
    dev, split = device_split(call, 10)
    plain_ms = time_ms(rotating([
        lambda t=t: plain_ssd_grads(t[:5], t[5], None, MAMBA_CHUNK)
        for t in ins]), 4)
    bound, by = ssd_bwd_bound_ms(ins[0][0], ins[0][1], ins[0][3], False)
    scratch = SS.bwd_scratch_bytes(B, S, MAMBA_H, MAMBA_P, MAMBA_N)
    regs = [f"{k} {r} registers, {sp} bytes spill stores"
            for k, r, sp in ptxas_entries(build.LOGS.get("ssd_scan", ""))
            if k.startswith(("ssd_grad", "ssd_rpass", "ssd_bwd"))
            or k.endswith(",true>")]
    occ = SS.grad_occupancy(MAMBA_N, MAMBA_P, torch.bfloat16)
    cover = dev / ms
    log(f"ssd_scan_bwd bf16 gradient pass at N={MAMBA_N}, P={MAMBA_P}: "
        f"{occ['smem_bytes']} bytes of shared memory a CTA, "
        f"{occ['ctas_per_sm']} CTA(s) a SM of {occ['threads']} threads, "
        f"{occ['registers']} registers and {occ['local_bytes']} local "
        f"bytes a thread (cudaOccupancyMaxActiveBlocksPerMultiprocessor, "
        f"cudaFuncGetAttributes)")
    log(f"ssd_scan_bwd bf16 training [{B},{S},{MAMBA_H},{MAMBA_P}] "
        f"N={MAMBA_N} (chunks, heads a CTA {SS.plan(B, S, MAMBA_H)}, "
        f"scratch {scratch / 1e6:.1f} MB): {ms:.4f} ms a call by CUDA "
        f"events (turns " + ", ".join(f"{d:.4f}" for d in runs)
        + f"); profiler device time {dev:.4f} ms summed over its kernels, "
        f"{100 * cover:.1f} % of the event time"
        + (" (under 90 %: the profiler lost events, the split is partial)"
           if cover < 0.9 else "")
        + ", per kernel "
        + "; ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"; {ms / bound:.1f}x the bound {bound:.5f} ms ({by}); plain "
        f"(autograd of ssd_chunked_plain with its recompute) {plain_ms:.3f}"
        f" ms; no PyTorch library call computes the SSD scan's gradient; "
        + ("; ".join(regs) or "registers not in the build log"))
    del ins, call
    release()
    return {"name": SSD_BWD_NAME, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/models/ssm.py:34",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


CONV_NAMES = ("causal_conv[mamba2 training 16x2048]",
              "causal_conv_bwd[mamba2 training 16x2048]")
# the shapes the conv kernels are timed at: mamba2-130m's training cell
# (16 x 2048, the (x, B, C) columns of the in-projection's 3352) and
# granite-4.0-h-small's longest padded prefill (1 x 6720, 8448 of 16768
# columns, bias and window); both buffers exceed the 50 MB L2
CONV_TIMED = (("training", (16, 2048, 1792, 4, 3352, 1536, False, False)),
              ("granite prefill", (1, 6720, 8448, 4, 16768, 8192, True,
                                   True)))


def conv_bound_ms(x, window, grad):
    """x read once and y written once (the gradient: x and dy read, dx
    written), the window read once (and its gradient written), at the
    card's HBM rate: a few operations an element, so bytes bound it."""
    n = x.numel() * x.element_size()
    w = 0 if window is None else window.numel() * window.element_size()
    return 1e3 * ((3 if grad else 2) * n + (2 if grad else 1) * w) \
        / HBM_BYTES_PER_S


def phase_conv(rows):
    """causal_conv and causal_conv_bwd (the Mamba-2 block's depthwise
    conv with its bias and SiLU, and its gradient) against their plain
    versions over ``ref.CONV_SWEEP``, f32 and bf16: the forward within
    CONV_TOL of ref_causal_conv computed in f32 and rounded once, every
    gradient within CONV_TOL of ref_causal_conv_bwd, no NaN, a second call
    equal to the bit.  Then, in bf16 at CONV_TIMED's shapes, each kernel's
    time a call by CUDA events (three turns of 50 calls, the median) beside
    the bound (bytes) and the plain version's (the stack + einsum + bias +
    SiLU the model ran before; for the gradient autograd's backward
    through it, its graph built beforehand), the conv work of one
    training step (48 forwards, 24 gradients at 24 layers with remat), and
    the kernels' registers and spills (the build log).  No PyTorch call
    computes the conv with its SiLU.  Two rows, the training shape's;
    their launches come from phase launch."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import (CONV_SWEEP, CONV_TOL,
                                         ref_causal_conv, ref_causal_conv_bwd)

    def inputs(case, dtype, seed):
        B, S, dc, K, width, off, bias, window = case
        x = seeded((B, S, width), dtype, seed)[..., off:off + dc]
        w = seeded((dc, K), dtype, seed + 1, 0.5)
        b = seeded((dc,), dtype, seed + 2, 0.3) if bias else None
        win = seeded((B, K - 1, dc), dtype, seed + 3) if window else None
        return x, w, b, win, seeded((B, S, dc), dtype, seed + 4)

    def rel(got, want):
        want = want.float()
        return float((got.float() - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)

    errs = {}
    for i, case in enumerate(CONV_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            x, w, b, win, dy = inputs(case, dtype, 900 + 10 * i)
            f = [t if t is None else t.float() for t in (x, w, b, win, dy)]
            y = kops.causal_conv(x, w, b, win)
            y2 = kops.causal_conv(x, w, b, win)
            g = kops.causal_conv_bwd(x, w, b, win, dy,
                                     want_window=win is not None)
            g2 = kops.causal_conv_bwd(x, w, b, win, dy,
                                      want_window=win is not None)
            torch.cuda.synchronize()
            want = ref_causal_conv_bwd(*f, want_window=win is not None)
            e = {"y": rel(y, ref_causal_conv(*f[:4]).to(dtype))}
            e.update({k: rel(a, r) for k, a, r in
                      zip(("dx", "dw", "db", "dwin"), g, want)
                      if r is not None})
            bitwise = torch.equal(y, y2) and all(
                torch.equal(a, c) for a, c in zip(g, g2) if a is not None)
            nan = any(bool(torch.isnan(t.float()).any())
                      for t in (y,) + tuple(g) if t is not None)
            log(f"causal_conv {case} {name}: bitwise repeat {bitwise}; max "
                f"rel err " + " ".join(f"{k} {v:.2e}" for k, v in e.items())
                + f" (tol {CONV_TOL[name]})")
            check(all(v <= CONV_TOL[name] for v in e.values()) and not nan,
                  f"causal_conv disagrees at {case} {name}: {e}")
            check(bitwise, f"causal_conv is not bitwise repeatable at "
                  f"{case} {name}")
            if case == CONV_TIMED[0][1] and name == "bfloat16":
                errs = e
            del x, w, b, win, dy, f, y, y2, g, g2, want
            release()

    timed = {}
    for label, case in CONV_TIMED:
        x, w, b, win, dy = inputs(case, torch.bfloat16, 990)
        fwd = [time_ms(lambda: kops.causal_conv(x, w, b, win), 50)
               for _ in range(3)]
        bwd = [time_ms(lambda: kops.causal_conv_bwd(x, w, b, win, dy), 50)
               for _ in range(3)]
        ps = [t if t is None else t.detach().clone().requires_grad_(True)
              for t in (x, w, b, win)]
        plain_fwd = time_ms(lambda: ref_causal_conv(x, w, b, win), 10)
        yp = ref_causal_conv(*ps)
        leaves = [t for t in ps if t is not None]
        plain_bwd = time_ms(lambda: torch.autograd.grad(
            yp, leaves, dy, retain_graph=True), 10)
        t = {"fwd": sorted(fwd)[1], "bwd": sorted(bwd)[1],
             "fwd_bound": conv_bound_ms(x, win, False),
             "bwd_bound": conv_bound_ms(x, None, True),
             "plain_fwd": plain_fwd, "plain_bwd": plain_bwd}
        timed[label] = t
        log(f"causal_conv bf16 {label} {list(case[:4])}: forward "
            f"{t['fwd']:.4f} ms a call by CUDA events (turns "
            + ", ".join(f"{v:.4f}" for v in fwd)
            + f"), {t['fwd'] / t['fwd_bound']:.2f}x the bound "
            f"{t['fwd_bound']:.4f} ms (bytes), plain {plain_fwd:.3f} ms; "
            f"gradient {t['bwd']:.4f} ms (turns "
            + ", ".join(f"{v:.4f}" for v in bwd)
            + f"), {t['bwd'] / t['bwd_bound']:.2f}x the bound "
            f"{t['bwd_bound']:.4f} ms (bytes), plain backward "
            f"{plain_bwd:.3f} ms")
        del x, w, b, win, dy, ps, yp, leaves
        release()
    tr = timed["training"]
    step = 48 * tr["fwd"] + 24 * tr["bwd"]
    log(f"causal_conv: a mamba2-130m training step's conv work (48 "
        f"forwards, 24 gradients at [16, 2048, 1792]) {step:.2f} ms on the "
        f"kernels, bound {48 * tr['fwd_bound'] + 24 * tr['bwd_bound']:.2f} "
        f"ms, plain {48 * tr['plain_fwd'] + 24 * tr['plain_bwd']:.1f} ms")
    regs = [f"{k} {r} registers, {sp} bytes spill stores"
            for k, r, sp in ptxas_entries(build.LOGS.get("causal_conv", ""))
            if "<bf16,4,true>" in k or "<f32,4,true>" in k
            or k.startswith("causal_conv_bwd_sum")]
    log(f"causal_conv registers: " + ("; ".join(regs) or "not in the build "
        "log"))
    out = []
    for name, key in zip(CONV_NAMES, ("fwd", "bwd")):
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/causal_conv.cu",
                    "replaces": "src/repro/models/ssm.py (the conv einsum; "
                                "no TPU kernel)",
                    "launches": None,
                    "max_abs_err": max(errs.values()) if errs else None,
                    "ms": tr[key], "plain_ms": tr["plain_" + key],
                    "bound_ms": tr[key + "_bound"], "bound_by": "bytes",
                    "library_ms": None,
                    "granite_prefill_ms": timed["granite prefill"][key]})
    rows.extend(out)


MAMBA_SERVE_KW = dict(max_slots=16, max_len=2048)


def phase_mamba2_serving(rows):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg = get_config("mamba2-130m")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"mamba2-130m: {M.param_count(params) / 1e6:.1f} M params "
        f"({cfg.param_dtype}), {cfg.n_layers} ssd layers")
    sched = ContinuousBatchingScheduler(cfg, params, **MAMBA_SERVE_KW)
    reqs = make_requests(cfg, 24, seed=3, prompt_lo=64, prompt_hi=1024,
                         new_lo=32, new_hi=128)
    # counts of the main path only: zeroed just before it, read just after
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["ssd_scan"]
    st = sched.stats
    sched.close()

    for i, r in enumerate(reqs):
        check(r.out_tokens is not None
              and len(r.out_tokens) == r.max_new_tokens,
              f"mamba2 request {i} got {len(r.out_tokens or [])} of "
              f"{r.max_new_tokens} tokens")
    check(st["phase"] == "co-execution", f"mamba2 phase {st['phase']}")
    check(st["iterations"] == st["decode_steps"],
          "engine iterations != scheduler decode steps")
    check(st["prefill_tokens"] == sum(len(r.prompt) for r in reqs),
          "prompts were not admitted at exact length")
    # every prefill (eager, both arms) runs the SSD scan once per layer;
    # decode runs ssd_decode_step, no kernel
    check(launches == cfg.n_layers * st["prefill_steps"] and launches > 0,
          f"ssd_scan launches {launches} != {cfg.n_layers} layers x "
          f"{st['prefill_steps']} prefill steps")
    gen = st["generated_tokens"]
    log(f"mamba2 serving: {len(reqs)} requests, {gen} tokens in {wall:.2f} s "
        f"= {gen / wall:.1f} tokens/s (bring-up reading, includes tracing "
        f"and warm-up), decode steps {st['decode_steps']}, prefill steps "
        f"{st['prefill_steps']} ({st['prefill_tokens']} prompt tokens), "
        f"ssd_scan launches {launches} = {st['prefill_steps']} x "
        f"{cfg.n_layers} layers")
    keys = ("phase", "iterations", "traced_iterations", "steady_iters",
            "retraces", "replays", "graph_versions", "families",
            "kernels_substituted", "segments_dispatched",
            "segments_recompiled", "admitted", "retired",
            "generated_tokens", "decode_steps", "prefill_steps",
            "prefill_tokens")
    log("mamba2 serving counters: " + json.dumps({k: st.get(k) for k in keys}))
    log(f"mamba2 serving launches: {json.dumps(counts)}")
    rows[3]["launches"] = launches
    del sched, params
    release()


def phase_mamba2_equality():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.kernels import ops as kops
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("mamba2 equality: float32, allow_tf32=False for matmul and cuDNN")
    cfg = dataclasses.replace(get_config("mamba2-130m"), n_layers=4,
                              dtype="float32", param_dtype="float32")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(1))
    cpu_params = tree_map(lambda t: t.cpu(), params)
    arms = {"kernel": (params, {}),
            "use_terra=False": (params, dict(use_terra=False)),
            "cpu": (cpu_params, dict(device="cpu"))}
    outs = {}
    for name, (p, kw) in arms.items():
        reqs = make_requests(cfg, 8, seed=4, prompt_lo=16, prompt_hi=256,
                             new_lo=16, new_hi=32)
        before = kops.ssd_scan.launches
        sched = ContinuousBatchingScheduler(cfg, p, max_slots=4, max_len=512,
                                            **kw)
        sched.serve(reqs)
        st = sched.stats
        sched.close()
        n = kops.ssd_scan.launches - before
        outs[name] = reqs
        log(f"mamba2 token arm {name}: {sum(len(r.out_tokens) for r in reqs)}"
            f" tokens, phase {st.get('phase')}, prefill steps "
            f"{st['prefill_steps']}, ssd_scan launches {n}")
        want = 0 if name == "cpu" else cfg.n_layers * st["prefill_steps"]
        check(n == want and (name == "cpu" or n > 0),
              f"mamba2 arm {name}: ssd_scan launches {n} != {want}")
    base = outs["kernel"]
    for name in ("use_terra=False", "cpu"):
        for i, (a, b) in enumerate(zip(base, outs[name])):
            if a.out_tokens == b.out_tokens:
                continue
            step = next(j for j, (x, y) in enumerate(
                zip(a.out_tokens, b.out_tokens)) if x != y)
            gap = top2_gap(cfg, params, list(a.prompt) + a.out_tokens[:step])
            raise SmokeFailure(
                f"mamba2 greedy tokens differ: kernel vs {name}, request {i}"
                f", step {step}: {a.out_tokens[step]} vs "
                f"{b.out_tokens[step]}, top-2 logit gap {gap:.3e}")
    log("mamba2 token equality: kernel == use_terra=False == cpu on all "
        f"{len(base)} requests")

    ids = np.random.RandomState(5).randint(0, cfg.vocab, (2, 512)).astype(
        np.int32)
    with torch.no_grad():
        on_card = M.forward(cfg, params, torch.from_numpy(ids).cuda())
        on_cpu = M.forward(cfg, cpu_params, torch.from_numpy(ids))
    err, ok = close_err(on_card.cpu(), on_cpu, 1e-4)
    log(f"mamba2 forward logits [2, 512] card vs cpu (float32): max_abs_err "
        f"{err:.3e} (tol 1e-4)")
    check(ok, f"mamba2 forward logits card vs cpu differ: {err}")
    del on_card, on_cpu, params, cpu_params
    release()

    cfg = get_config("mamba2-130m")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    ids = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab, (4, 2048)).astype(np.int32)).cuda()
    before = kops.ssd_scan.launches
    with torch.no_grad():
        logits = M.forward(cfg, params, ids)
    torch.cuda.synchronize()
    n = kops.ssd_scan.launches - before
    finite = bool(torch.isfinite(logits).all())
    log(f"mamba2 forward [4, 2048] bf16, {cfg.n_layers} layers: logits "
        f"{tuple(logits.shape)}, finite {finite}, ssd_scan launches {n}")
    check(n == cfg.n_layers, f"forward launched ssd_scan {n} times, not "
          f"{cfg.n_layers}")
    check(finite and tuple(logits.shape) == (4, 2048, cfg.vocab),
          "mamba2 forward logits not finite or misshapen")
    del logits, params
    release()


# --------------------------------------------------------------------------
# training: the paper's ten programs (phase 9) and the LM trainer (phase 10)
# --------------------------------------------------------------------------

PROGRAM_WARMUP, PROGRAM_MEASURE = 12, 40     # fig5_throughput.py's counts
PROGRAM_CHECK_ITERS = 20
PROGRAM_RTOL = 1e-4        # f32 losses card vs CPU (TF32 off)
PROGRAM_KEYS = ("traced_iterations", "transitions", "retraces", "replays",
                "replayed_entries", "graph_versions", "iterations",
                "families", "segments_dispatched", "walker_fast_hits")

# examples/train_lm.py's "100m" preset, copied (this script imports
# nothing of examples/); tests/test_torch_train.py holds it equal
TRAIN_100M = dict(cfg=dict(
    name="lm-100m", family="dense", n_layers=10, d_model=640,
    n_heads=10, n_kv_heads=10, d_ff=2560, vocab=50304, head_dim=64,
    rope_theta=10000.0, block_pattern=("attn",), remat=True,
    q_block=128, kv_block=256),
    batch=4, seq_len=256)
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_RESUME_STEPS = 40, 20, 10
PARITY_LAYERS, PARITY_STEPS, PARITY_BATCH, PARITY_SEQ = 2, 8, 2, 128
PARITY_RTOL = 1e-3         # f32 losses after 8 AdamW steps (see phase 10)


def time_program(core, programs, name, variant):
    """ms per iteration of one program variant (after the warm-up), as
    fig5_throughput.time_variant measures it, with the card synced before
    each clock read; -> (ms, stats of the terra variant)."""
    import torch
    step, _ = programs.REGISTRY[name](variant)
    stats = {}
    if variant == "terra":
        tf = core.function(step)
        for i in range(PROGRAM_WARMUP):
            tf(i)
        tf.wait()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(PROGRAM_WARMUP, PROGRAM_WARMUP + PROGRAM_MEASURE):
            tf(i)
        tf.wait()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats = {k: tf.stats.get(k) for k in PROGRAM_KEYS}
        stats["phase"] = tf.phase
        tf.close()
    else:
        with core.imperative() as imp:
            for i in range(PROGRAM_WARMUP):
                step(i)
                imp.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(PROGRAM_WARMUP, PROGRAM_WARMUP + PROGRAM_MEASURE):
                step(i)
                imp.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    return dt / PROGRAM_MEASURE * 1e3, stats


def program_losses(core, programs, name, device):
    """Losses (each fetched) and counters of PROGRAM_CHECK_ITERS terra
    iterations of one program on ``device``."""
    step, _ = programs.REGISTRY[name]("terra", device=device)
    tf = core.function(step, device=device)
    losses = [float(tf(i)) for i in range(PROGRAM_CHECK_ITERS)]
    tf.wait()
    stats = {k: tf.stats.get(k) for k in PROGRAM_KEYS}
    stats["phase"] = tf.phase
    tf.close()
    return losses, stats


def phase_programs():
    import numpy as np
    import torch
    from repro_torch import core, programs

    log(f"programs: {len(programs.REGISTRY)} programs x (terra, imperative),"
        f" {PROGRAM_WARMUP} warm-up + {PROGRAM_MEASURE} measured iterations"
        f" (float32, allow_tf32={torch.backends.cuda.matmul.allow_tf32})")
    table = {}
    for name in sorted(programs.REGISTRY):
        imp_ms, _ = time_program(core, programs, name, "imperative")
        terra_ms, st = time_program(core, programs, name, "terra")
        table[name] = dict(terra_ms=round(terra_ms, 4),
                           imperative_ms=round(imp_ms, 4),
                           speedup=round(imp_ms / terra_ms, 3), **st)
        log(f"program {name}: terra {terra_ms:.3f} ms/iter, imperative "
            f"{imp_ms:.3f} ms/iter, imperative/terra {imp_ms / terra_ms:.3f}"
            f"; {json.dumps(st)}")
        check(st["phase"] == "co-execution",
              f"program {name} terra phase {st['phase']}")
    log("programs table: " + json.dumps(table))
    release()

    # the same programs fetched every iteration, card against CPU: the
    # dropout mask is a counter hash of (key, element index), made alike
    # on both, so dropblock's losses compare too
    log(f"programs card vs cpu: {PROGRAM_CHECK_ITERS} terra iterations, "
        f"float32, TF32 off, losses to rtol {PROGRAM_RTOL}")
    for name in sorted(programs.REGISTRY):
        card, st_card = program_losses(core, programs, name, None)
        cpu, st_cpu = program_losses(core, programs, name, "cpu")
        a, b = np.asarray(card), np.asarray(cpu)
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        log(f"program {name} card vs cpu: max rel err {rel:.3e}, losses "
            f"{a[0]:.6f} -> {a[-1]:.6f}, counters equal "
            f"{st_card == st_cpu}")
        check(st_card == st_cpu, f"program {name} counters card "
              f"{st_card} != cpu {st_cpu}")
        check(np.all(np.isfinite(a)) and rel <= PROGRAM_RTOL,
              f"program {name} losses card vs cpu: rel err {rel:.3e}")
    release()


class _SyncedSteps:
    """A Trainer's iteration that waits for the step to finish: the
    engine's dispatch queue drained and the card synced (the GraphRunner
    thread may not have issued the step's kernels when the call returns).
    The host-read step time then covers the whole step."""

    def __init__(self, it):
        self.it, self.times = it, []

    def __call__(self, *args):
        import torch
        t0 = time.perf_counter()
        out = self.it(*args)
        self.it.wait()
        torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self.it, name)


def train_parity_losses(cfg, init_dir, device, use_terra):
    """PARITY_STEPS logged losses of a Trainer resumed from the step-0
    checkpoint in ``init_dir``, so every arm starts alike (it then saves
    nothing: the next arm resumes from the same step 0)."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    tr = Trainer(cfg, OptConfig(warmup_steps=2, total_steps=100),
                 ckpt_dir=init_dir, batch=PARITY_BATCH, seq_len=PARITY_SEQ,
                 log_every=1, use_terra=use_terra, device=device)
    check(tr.start_step == 0, f"parity arm resumed at {tr.start_step}")
    tr.ckpt_dir = None
    hist = tr.train(PARITY_STEPS, verbose=False)
    phase = tr._iteration.phase if use_terra else "eager"
    if use_terra:
        tr._iteration.close()
    return [l for _, l in hist], phase


def phase_train():
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    cfg = ModelConfig(**TRAIN_100M["cfg"])
    opt_cfg = OptConfig(warmup_steps=5, total_steps=TRAIN_STEPS
                        + TRAIN_RESUME_STEPS)
    kw = dict(batch=TRAIN_100M["batch"], seq_len=TRAIN_100M["seq_len"],
              log_every=1, ckpt_every=TRAIN_CKPT_EVERY)
    d = tempfile.mkdtemp(prefix="train_100m_")
    try:
        log(f"train: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
            f"allocated before the trainer")
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, opt_cfg, ckpt_dir=d, **kw)
        n = M.param_count(tr.state_tree()["params"])
        log(f"train: {cfg.name}, {n / 1e6:.1f} M params ({cfg.param_dtype}),"
            f" {cfg.n_layers} layers, remat {cfg.remat} "
            f"({cfg.remat_policy}), batch {kw['batch']} x {kw['seq_len']}"
            f" tokens, {TRAIN_STEPS} steps, checkpoint every "
            f"{TRAIN_CKPT_EVERY}")
        timed = tr._iteration = _SyncedSteps(tr._iteration)
        t0 = time.perf_counter()
        hist = tr.train(TRAIN_STEPS, verbose=False)
        wall = time.perf_counter() - t0
        st = timed.stats
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [l for _, l in hist]
        steady = timed.times[st["traced_iterations"]:]
        med = float(np.median(steady)) * 1e3
        log(f"train 100m: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(steps {hist[0][0]}..{hist[-1][0]}), phase {timed.phase}, "
            f"median step {med:.2f} ms over {len(steady)} co-executed "
            f"steps (each step waited for; min {min(steady) * 1e3:.2f}, "
            f"max {max(steady) * 1e3:.2f}), first step "
            f"{timed.times[0] * 1e3:.1f} ms, wall {wall:.2f} s with the "
            f"checkpoints, {TRAIN_100M['batch'] * TRAIN_100M['seq_len'] / med * 1e3:.0f}"
            f" tokens/s at the median, max_memory_allocated {peak:.3f} GiB")
        log("train 100m losses: " + json.dumps([round(l, 5) for l in losses]))
        keys = ("phase", "iterations", "traced_iterations", "transitions",
                "retraces", "replays", "graph_versions",
                "segments_dispatched", "walker_fast_hits")
        log("train 100m counters: " + json.dumps(
            {k: st.get(k) for k in keys} | {"phase": timed.phase}))
        log(f"train 100m straggler events: {len(tr.straggler_events)}")
        check(timed.phase == "co-execution", f"train phase {timed.phase}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"train 100m loss did not fall: {losses[0]} -> {losses[-1]}")
        check(ckpt.latest_step(d) == TRAIN_STEPS
              and os.path.isdir(os.path.join(d, f"step_{TRAIN_CKPT_EVERY}")),
              "train 100m checkpoints missing")
        timed.close()
        del tr, timed
        release()

        tr2 = Trainer(cfg, opt_cfg, ckpt_dir=d, **kw)
        check(tr2.start_step == TRAIN_STEPS,
              f"resume started at {tr2.start_step}, not {TRAIN_STEPS}")
        h2 = tr2.train(TRAIN_RESUME_STEPS, verbose=False)
        log(f"train 100m resume: from step {tr2.start_step}, steps "
            f"{h2[0][0]}..{h2[-1][0]}, loss {h2[0][1]:.4f} -> "
            f"{h2[-1][1]:.4f}, phase {tr2._iteration.phase}")
        check(h2[0][0] == TRAIN_STEPS + 1 and all(np.isfinite(
            [l for _, l in h2])), "train 100m resume failed")
        tr2._iteration.close()
        del tr2
    finally:
        shutil.rmtree(d, ignore_errors=True)
    release()

    # parity at the same width, 2 layers, float32, TF32 off: every arm
    # resumes from one step-0 checkpoint (written by the CPU trainer), so
    # all start from the same weights.  AdamW's first steps move every
    # weight by about lr whatever its gradient's size, so a near-zero
    # gradient whose sign differs between devices moves its weight the
    # other way: PARITY_RTOL allows for that.
    pcfg = dataclasses.replace(cfg, n_layers=PARITY_LAYERS, dtype="float32",
                               param_dtype="float32")
    init = tempfile.mkdtemp(prefix="parity_init_")
    try:
        Trainer(pcfg, OptConfig(), ckpt_dir=init, batch=PARITY_BATCH,
                seq_len=PARITY_SEQ, use_terra=False,
                device="cpu").train(0, verbose=False)
        arms = {}
        for name, device, terra in (("card terra", None, True),
                                    ("card eager", None, False),
                                    ("cpu terra", "cpu", True)):
            t0 = time.perf_counter()
            arms[name], phase = train_parity_losses(pcfg, init, device, terra)
            log(f"train parity arm {name}: phase {phase}, losses "
                f"{json.dumps([round(l, 6) for l in arms[name]])} "
                f"({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(init, ignore_errors=True)
    base = np.asarray(arms["card terra"])
    for name in ("card eager", "cpu terra"):
        rel = float(np.max(np.abs(np.asarray(arms[name]) - base)
                           / np.abs(base)))
        log(f"train parity card terra vs {name}: max rel err {rel:.3e} "
            f"(rtol {PARITY_RTOL})")
        check(rel <= PARITY_RTOL, f"train parity vs {name}: {rel:.3e}")
    release()


# --------------------------------------------------------------------------
# phase 11: captured segments (core/capture.py) against disable_jit()
# --------------------------------------------------------------------------

CAPTURE_EQ_LAYERS = 4          # the equality arms' depth (float32)


def arm_context(eager):
    """The ``disable_jit()`` block of an eager arm (nothing for the
    captured one): an arm's segments and chains are compiled inside it."""
    import contextlib
    from repro_torch.core import capture
    return capture.disable_jit() if eager else contextlib.nullcontext()


def captured_segments(engine):
    """(captured, total) segments of an engine's current program, and its
    CaptureContext counters."""
    from repro_torch.core.capture import CapturedFn
    sps = engine.gp.seg_progs if engine.gp is not None else []
    n = sum(isinstance(sp.fn, CapturedFn) for sp in sps)
    return n, len(sps), dict(engine.capture.stats)


def check_captured(label, engine):
    """Every segment of the path's program is a CUDA graph, none ran
    eagerly, and graphs were replayed."""
    n, total, st = captured_segments(engine)
    log(f"capture {label}: {n} of {total} segments captured, "
        f"{json.dumps(st)}")
    check(total > 0 and n == total and st["eager_fns"] == 0,
          f"{label}: {n} of {total} segments captured, "
          f"{st['eager_fns']} compiled eager")
    check(st["graphs"] > 0 and st["replays"] > 0,
          f"{label}: no graph was captured and replayed")


def check_eager(label, engine):
    n, total, st = captured_segments(engine)
    log(f"capture {label} under disable_jit(): {n} of {total} segments "
        f"captured")
    check(n == 0 and st["graphs"] == 0, f"{label}: captured under "
          f"disable_jit()")


def capture_equality():
    """Captured and disable_jit() arms at full width, float32, TF32 off:
    llama decode (4 layers; co-executed and use_terra=False), the scoring
    program (4 layers), the trainer (2 layers of the 100m preset) and
    mamba2 serving (4 layers): tokens equal, scores within 1e-4 (phase
    6's rule), losses within PARITY_RTOL (phase 10's)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, kw in (("llama3-8b", dict(optimize=KERNELS, **SERVE_KW)),
                     ("mamba2-130m", dict(max_slots=4, max_len=512))):
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=CAPTURE_EQ_LAYERS,
                                  dtype="float32", param_dtype="float32")
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(1))
        toks = {}
        for terra in (True, False):
            for eager in (False, True):
                reqs = make_requests(cfg, 6, seed=7, prompt_lo=16,
                                     prompt_hi=128, new_lo=16, new_hi=24)
                with arm_context(eager):
                    sched = ContinuousBatchingScheduler(
                        cfg, params, use_terra=terra, **kw)
                    sched.serve(reqs)
                label = f"{arch} {'terra' if terra else 'use_terra=False'}"
                if terra:
                    eng = sched._tf.engine
                    (check_eager if eager else check_captured)(label, eng)
                else:
                    ctx = sched._capture
                    log(f"capture {label}: {json.dumps(ctx and ctx.stats)}")
                    check((ctx is None) == eager
                          and (eager or ctx.stats["replays"] > 0),
                          f"{label}: baseline capture {ctx and ctx.stats}")
                sched.close()
                toks[(terra, eager)] = [r.out_tokens for r in reqs]
        base = toks[(True, True)]
        for key, got in toks.items():
            check(got == base, f"{arch} greedy tokens differ: arm {key} vs "
                  f"terra disable_jit")
        log(f"capture {arch}: greedy tokens equal, captured == "
            f"disable_jit() for terra and use_terra=False "
            f"({sum(len(t) for t in base)} tokens)")
        del params, sched
        release()

    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=CAPTURE_EQ_LAYERS, dtype="float32",
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(1))
    scores = {}
    for eager in (False, True):
        with arm_context(eager):
            step = llama_score_program(core, cfg, params, SCORE_BATCH,
                                       SCORE_SEQ)
            scores[eager] = [score_call(step, cfg, i) for i in range(5)]
            step.wait()
        (check_eager if eager else check_captured)("scoring", step.engine)
        step.close()
    diff = max(float(abs(a - b).max())
               for a, b in zip(scores[False], scores[True]))
    log(f"capture scoring: float32 scores captured vs disable_jit() max "
        f"abs diff {diff:.3e} (tol 1e-4)")
    check(diff <= 1e-4, f"captured scores differ: {diff:.3e}")
    del params, step
    release()

    pcfg = dataclasses.replace(ModelConfig(**TRAIN_100M["cfg"]),
                               n_layers=PARITY_LAYERS, dtype="float32",
                               param_dtype="float32")
    init = tempfile.mkdtemp(prefix="capture_init_")
    losses = {}
    try:
        Trainer(pcfg, OptConfig(), ckpt_dir=init, batch=PARITY_BATCH,
                seq_len=PARITY_SEQ, use_terra=False,
                device="cpu").train(0, verbose=False)
        for eager in (False, True):
            with arm_context(eager):
                tr = Trainer(pcfg, OptConfig(warmup_steps=2,
                                             total_steps=100),
                             ckpt_dir=init, batch=PARITY_BATCH,
                             seq_len=PARITY_SEQ, log_every=1)
                tr.ckpt_dir = None
                losses[eager] = [l for _, l in tr.train(PARITY_STEPS,
                                                        verbose=False)]
            eng = tr._iteration.engine
            (check_eager if eager else check_captured)("train", eng)
            tr._iteration.close()
    finally:
        shutil.rmtree(init, ignore_errors=True)
    a, b = np.asarray(losses[False]), np.asarray(losses[True])
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    log(f"capture train: float32 losses captured vs disable_jit() max rel "
        f"err {rel:.3e} (rtol {PARITY_RTOL}): {json.dumps(a.tolist())}")
    check(np.all(np.isfinite(a)) and rel <= PARITY_RTOL,
          f"captured losses differ: {rel:.3e}")
    del tr
    release()


def busy_window(run):
    """(wall s, device busy s, units, {kernel: launches}) of one ``run()``
    under torch.profiler: the device time summed over every kernel."""
    units, wall, kernels = profiled(run)
    busy = sum(us for _, us, _ in kernels) / 1e6
    return wall, busy, units, {key: n for key, _, n in kernels}


PROFILED_SHARE = 0.9     # least share of counted launches the profiler sees
CAPTURE_TURNS = ("eager", "captured", "captured", "eager", "eager",
                 "captured")


def capture_turns(label, unit, arms, kernels=()):
    """Both arms of one path in turns, then one profiler window each:
    time per unit (host wall with the card synced, median of the arm's
    three turns), device time per unit (profiler), the busy share (device
    time over the turns' wall; the profiler window's own share beside
    it), peak memory, graphs, replays and bytes copied into and out of
    graphs per unit.  ``arms``: name -> (run, ctx), where ``run()`` does
    one timed batch in its arm's context and returns its units.
    ``kernels``: (launch counter, kernel names, launches per unit); in
    the captured window each counter must advance by exactly that many
    launches per unit (a replay adds its graph's launches without calling
    the wrapper), and the profiler must see those kernels launched at
    least PROFILED_SHARE times as often as counted and no more often (a
    window drops some of its events now and then: 0.3-4.3 % of the paged
    launches on an H100, as phase 2's medians allow for; a graph that
    misses its kernels shows far less; the share is logged)."""
    import numpy as np
    import torch
    times = {name: [] for name in arms}
    out = {}
    for name in CAPTURE_TURNS:
        run, ctx = arms[name]
        st0 = dict(ctx.stats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        units = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        times[name].append(wall / units * 1e3)
        row = out.setdefault(name, {})
        row["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
        for k in ("copy_in_bytes", "copy_out_bytes"):
            row[f"{k}_per_{unit}"] = (ctx.stats[k] - st0[k]) // units
        for k in ("graphs", "replays", "recaptures"):
            row[k] = ctx.stats[k]
    for name, (run, ctx) in arms.items():
        before = read_counts()
        wall, busy, units, launched = busy_window(run)
        after = read_counts()
        ms = float(np.median(times[name]))
        row = out[name]
        row["ms_per_" + unit] = round(ms, 3)
        row["turns_ms"] = [round(t, 3) for t in times[name]]
        row["device_ms_per_" + unit] = round(busy / units * 1e3, 3)
        row["busy_share"] = round(busy / units * 1e3 / ms, 4)
        row["busy_share_profiled"] = round(busy / wall, 4)
        for counter, names, per_unit in kernels:
            seen = sum(n for k, n in launched.items()
                       if any(x in k for x in names))
            counted = after[counter] - before[counter]
            row[f"{counter}_launches"] = [counted, seen]
            if name == "captured":
                check(counted == units * per_unit
                      and PROFILED_SHARE * counted <= seen <= counted,
                      f"{label}: {counter} counted {counted} launches "
                      f"({units} x {per_unit} expected), the profiler "
                      f"saw {seen}")
    log(f"capture timing {label}: {json.dumps(out)}")
    return out


# the timing arms' depth at full width: cut from 32 (llama: decode and
# scoring), 24 (mamba2) and 10 (the 100m trainer) layers, to keep the
# script's wall near 1.5x what it was before the families phase joined it
# (each profiler window over an eager arm costs time in proportion to its
# launches)
CAPTURE_TIMING_LAYERS = {"llama3-8b": 8, "mamba2-130m": 6, "train-100m": 5}


def capture_timing():
    """Full width at CAPTURE_TIMING_LAYERS depth, bf16, both arms in one
    call: llama3-8b steady decode (8 requests of 128 tokens, 48 new),
    mamba2-130m serving (16 requests of 512-527 tokens, 64 new), the
    scoring program (llama3-8b, 4 x 512 tokens, 5 calls a turn) and the
    100m trainer (10 steps a turn, each loss fetched)."""
    import torch
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    results, t0 = {}, time.perf_counter()
    for arch, kw, shape in (
            ("llama3-8b", dict(optimize=KERNELS, **SERVE_KW),
             (8, 128, 128, 48)),
            ("mamba2-130m", MAMBA_SERVE_KW, (16, 512, 527, 64))):
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=CAPTURE_TIMING_LAYERS[arch])
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        arms, engines = {}, {}
        for name in ("captured", "eager"):
            eager = name == "eager"
            with arm_context(eager):
                sched = ContinuousBatchingScheduler(cfg, params, **kw)

            def run(sched=sched, eager=eager, seed=[300]):
                seed[0] += 1
                reqs = make_requests(cfg, shape[0], seed[0], shape[1],
                                     shape[2], shape[3], shape[3])
                st0 = sched.stats["decode_steps"]
                with arm_context(eager):
                    sched.serve(reqs)
                return (sched.stats["decode_steps"] - st0
                        if arch == "llama3-8b" else 1)

            run()                           # tracing, steady entry
            run()                           # warm-up and capture
            engines[name] = sched
            arms[name] = (run, sched._tf.engine.capture)
        log(f"capture timing {arch}: warm at {time.perf_counter() - t0:.1f} s")
        results[arch] = capture_turns(
            arch, "decode_step" if arch == "llama3-8b" else "batch", arms,
            [("paged_attention", ("paged_split_kernel",), cfg.n_layers)]
            if arch == "llama3-8b" else ())
        check_captured(f"{arch} at {cfg.n_layers} layers",
                       engines["captured"]._tf.engine)
        for sched in engines.values():
            sched.close()
        del params, arms, engines, sched, run
        release()

    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=CAPTURE_TIMING_LAYERS["llama3-8b"])
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    arms, steps = {}, {}
    for name in ("captured", "eager"):
        eager = name == "eager"
        with arm_context(eager):
            step = llama_score_program(core, cfg, params, SCORE_BATCH,
                                       SCORE_SEQ)
            for i in range(5):      # trace (2 calls), warm-up, capture
                score_call(step, cfg, i)
            step.wait()

        def run(step=step, eager=eager):
            with arm_context(eager):
                for i in range(5):
                    score_call(step, cfg, 100 + i)
                step.wait()
            return 5

        steps[name] = step
        arms[name] = (run, step.engine.capture)
    log(f"capture timing scoring: warm at {time.perf_counter() - t0:.1f} s")
    results["scoring"] = capture_turns(
        "scoring", "call", arms,
        [("flash_attention", ("flash_bf16_kernel",), cfg.n_layers),
         ("rmsnorm", ("rmsnorm_reg_kernel", "rmsnorm_kernel"),
          2 * cfg.n_layers + 1)])
    check_captured(f"scoring at {cfg.n_layers} layers",
                   steps["captured"].engine)
    for step in steps.values():
        step.close()
    del params, arms, steps, step, run
    release()

    cfg = dataclasses.replace(ModelConfig(**TRAIN_100M["cfg"]),
                              n_layers=CAPTURE_TIMING_LAYERS["train-100m"])
    arms, trainers = {}, {}
    for name in ("captured", "eager"):
        eager = name == "eager"
        with arm_context(eager):
            tr = Trainer(cfg, OptConfig(warmup_steps=5, total_steps=100),
                         batch=TRAIN_100M["batch"],
                         seq_len=TRAIN_100M["seq_len"], log_every=1)
            tr.train(6, verbose=False)      # trace, warm-up, capture

        def run(tr=tr, eager=eager):
            with arm_context(eager):
                tr.train(10, verbose=False)
                tr._iteration.wait()
            return 10

        trainers[name] = tr
        arms[name] = (run, tr._iteration.engine.capture)
    log(f"capture timing train: warm at {time.perf_counter() - t0:.1f} s")
    results["train-100m"] = capture_turns("train 100m", "step", arms)
    check_captured("train 100m", trainers["captured"]._iteration.engine)
    for tr in trainers.values():
        tr._iteration.close()
    del arms, trainers, tr, run
    release()
    return results


def phase_capture():
    import torch
    release()
    base = torch.cuda.memory_allocated() / 2**30
    log("capture: captured segments against disable_jit(); equality at "
        f"{CAPTURE_EQ_LAYERS} layers in float32, then timing at "
        f"{json.dumps(CAPTURE_TIMING_LAYERS)} layers ({base:.3f} GiB "
        f"allocated before)")
    capture_equality()
    torch.backends.cuda.matmul.allow_tf32 = True
    results = capture_timing()
    release()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"capture: {left:.3f} GiB allocated after every engine closed and "
        f"release() ({left - base:+.3f} GiB over the phase)")
    check(left - base < 0.25, f"closed engines hold {left - base:.3f} GiB")
    log("capture table: " + json.dumps(results))
    for path, arms in results.items():
        a, b = arms["eager"], arms["captured"]
        key = next(k for k in a if k.startswith("ms_per_"))
        log(f"capture {path}: {key} eager {a[key]} -> captured {b[key]} "
            f"({a[key] / b[key]:.2f}x), busy {a['busy_share']:.3f} -> "
            f"{b['busy_share']:.3f}, peak {a['peak_gib']} -> "
            f"{b['peak_gib']} GiB")


# --------------------------------------------------------------------------
# phase 12: the MoE and RG-LRU families, served, and lock-step equality
# --------------------------------------------------------------------------

# (arch, layers kept (None: the published depth), scheduler settings,
# traffic: requests, prompt lengths, new tokens)
FAMILIES = (
    ("deepseek-moe-16b", None, SERVE_KW, (12, 16, 256, 32, 64)),
    # prompts admitted at exact length (recurrent state): up to 1024 tokens
    ("recurrentgemma-2b", None, dict(max_slots=8, max_len=1152,
                                     page_size=16), (16, 64, 1024, 32, 64)),
    # 56 layers would be 141 B params (282 GB in bf16): cut to 4
    ("mixtral-8x22b", 4, SERVE_KW, (12, 16, 256, 32, 64)),
)
# served only (no steady-decode turns, no equality): the paged kernel at
# G = 5 on a main path
SERVED_ONLY = (("qwen2.5-14b", None, SERVE_KW, (12, 16, 256, 32, 64)),)
# the steady-decode timing arms' depth, cut from 28 and 26 layers
# to keep the script's wall near 600 s once phase cross joined it (each
# eager arm's turn costs time in proportion to its launches); the served
# runs above stay at full depth
FAMILY_TIMING_LAYERS = {"deepseek-moe-16b": 8,
                        # two super-blocks and the two extra rglru blocks
                        "recurrentgemma-2b": 8}
FAMILY_EQ_LAYERS = {"deepseek-moe-16b": 4, "mixtral-8x22b": 4,
                    # one super-block (rglru, rglru, attn_local) and the
                    # two extra rglru blocks: the least depth with attention
                    "recurrentgemma-2b": 5}


def gib_allocated() -> float:
    import torch
    return round(torch.cuda.memory_allocated() / 2**30, 3)


def attn_layers(cfg) -> int:
    """Layers that read the paged cache (one paged launch each a step)."""
    from repro_torch.serve.scheduler.pool_ops import PAD_SAFE_KINDS
    return (cfg.n_pattern_blocks * sum(k in PAD_SAFE_KINDS
                                       for k in cfg.block_pattern)
            + sum(k in PAD_SAFE_KINDS for k in cfg.extra_blocks))


def family_config(arch, layers, **kw):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, **kw)


def serve_family(arch, layers, serve_kw, traffic, kernel_rows, steady=True):
    """One family at published width, bf16 random weights: served by the
    co-executed paged scheduler with the kernels pass (launch counters
    zeroed just before, read just after: the paged kernel runs once per
    attention layer per compiled decode step), every segment captured;
    then (``steady``) steady decode captured against disable_jit() in
    turns."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg = family_config(arch, layers)
    release()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    n_attn = attn_layers(cfg)
    log(f"families {arch}: {n_params / 1e9:.3f} B params "
        f"({n_params * 2 / 1e9:.1f} GB bf16), {cfg.n_layers} layers "
        f"({n_attn} with attention), init {time.perf_counter() - t0:.1f} s,"
        f" {gib_allocated()} GiB allocated")
    sched = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                        **serve_kw)
    n, lo, hi, new_lo, new_hi = traffic
    reqs = make_requests(cfg, n, seed=0, prompt_lo=lo, prompt_hi=hi,
                         new_lo=new_lo, new_hi=new_hi)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = sched.stats
    for i, r in enumerate(reqs):
        check(r.out_tokens is not None
              and len(r.out_tokens) == r.max_new_tokens,
              f"{arch}: request {i} got {len(r.out_tokens or [])} of "
              f"{r.max_new_tokens} tokens")
    check(st["phase"] == "co-execution", f"{arch}: phase {st['phase']}")
    check(st["kernels_substituted"] >= 1,
          f"{arch}: the kernels pass substituted nothing")
    compiled = st["iterations"] - st["traced_iterations"]
    launches = counts["paged_attention"]
    check(launches == compiled * n_attn and launches > 0,
          f"{arch}: paged_attention launches {launches} != {compiled} "
          f"compiled decode steps x {n_attn} attention layers")
    check_captured(f"{arch} serving", sched._tf.engine)
    gen = st["generated_tokens"]
    log(f"families {arch} serving: {len(reqs)} requests, {gen} tokens in "
        f"{wall:.2f} s = {gen / wall:.1f} tokens/s (includes tracing and "
        f"warm-up), decode steps {st['decode_steps']}, prefill steps "
        f"{st['prefill_steps']}, paged launches {launches} = {compiled} "
        f"compiled steps x {n_attn}; launches {json.dumps(counts)}")
    row = next(r for r in kernel_rows
               if r["name"] == f"paged_attention[{arch}]")
    row["launches"] = launches
    log(f"families {arch}: {gib_allocated()} GiB allocated after serving")
    if not steady:
        sched.close()
        del params, sched
        release()
        return None

    # steady decode, captured against disable_jit() in turns: this engine,
    # or at FAMILY_TIMING_LAYERS depth a fresh one
    t_layers = FAMILY_TIMING_LAYERS.get(arch)
    if t_layers is not None:
        sched.close()
        del params, sched
        release()
        cfg = family_config(arch, t_layers)
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        n_attn = attn_layers(cfg)
        sched = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                            **serve_kw)
        log(f"families {arch}: steady decode timed at {cfg.n_layers} "
            f"layers ({n_attn} with attention)")
    with arm_context(True):
        eager = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                            **serve_kw)
    log(f"families {arch}: {gib_allocated()} GiB allocated with both "
        f"schedulers")
    arms = {}
    for name, sc in (("captured", sched), ("eager", eager)):
        def run(sc=sc, jit_off=name == "eager", seed=[300]):
            seed[0] += 1
            batch = make_requests(cfg, 8, seed[0], 128, 128, 32, 32)
            st0 = sc.stats["decode_steps"]
            with arm_context(jit_off):
                sc.serve(batch)
            return sc.stats["decode_steps"] - st0
        if name == "eager" or t_layers is not None:
            run()                           # tracing, steady entry
        arms[name] = (run, sc._tf.engine.capture)
    out = capture_turns(arch, "decode_step", arms,
                        [("paged_attention", ("paged_split_kernel",),
                          n_attn)])
    for name, (run, _) in arms.items():
        out[name]["tokens_per_s"] = round(
            8e3 / out[name]["ms_per_decode_step"], 1)
    check_captured(f"{arch} steady decode", sched._tf.engine)
    check_eager(f"{arch} steady decode", eager._tf.engine)
    sched.close()
    eager.close()
    del params, sched, eager, arms, run, sc
    release()
    return out


def family_equality(arch):
    """Full width at FAMILY_EQ_LAYERS depth, float32, TF32 off: greedy
    tokens of four same-length requests equal across ServingEngine
    co-executed (captured), ServingEngine use_terra=False (captured), the
    co-executed paged scheduler with the kernels pass, and ServingEngine
    on the CPU; then the co-executed engine serves two rows of the same
    requests (a batch-size change: graph_versions bumps, tokens kept)."""
    import numpy as np
    import torch
    from repro_torch.core.pytree import tree_map
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    release()
    cfg = family_config(arch, FAMILY_EQ_LAYERS[arch], dtype="float32",
                        param_dtype="float32")
    # capacity factor E: no token ever drops (capacity = every token), so
    # batching does not change a row's experts (smoke_config's choice)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts or 1))
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(1))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab, 24).astype(np.int32)
               for _ in range(4)]
    news = [12, 8, 12, 10]

    def reqs():
        return [Request(prompt=p, max_new_tokens=m, arrival_time=0.0)
                for p, m in zip(prompts, news)]

    def lockstep(device, use_terra, params):
        eng = ServingEngine(cfg, params, max_len=64, use_terra=use_terra,
                            device=device)
        out = eng.run_batch(reqs())
        if use_terra and device is None:
            check_captured(f"{arch} lock-step", eng.terra.engine)
            versions = eng.terra.stats["graph_versions"]
            half = eng.run_batch(reqs()[:2])
            check(eng.terra.stats["graph_versions"] > versions,
                  f"{arch}: a batch-size change did not re-trace")
            check([r.out_tokens for r in half]
                  == [r.out_tokens for r in out[:2]],
                  f"{arch}: tokens changed with the batch size")
        eng.close()
        return [r.out_tokens for r in out]

    arms = {"lock-step": lockstep(None, True, params),
            "use_terra=False": lockstep(None, False, params)}
    sched = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                        max_slots=4, max_len=64,
                                        page_size=16)
    served = sched.serve(reqs())
    sched.close()
    arms["scheduler"] = [r.out_tokens for r in served]
    arms["cpu"] = lockstep("cpu", True,
                           tree_map(lambda t: t.cpu(), params))
    base = arms["lock-step"]
    for name, toks in arms.items():
        check(toks == base, f"{arch}: greedy tokens differ, lock-step "
              f"{base} vs {name} {toks}")
    log(f"families {arch} equality at {cfg.n_layers} layers (f32): "
        f"lock-step == use_terra=False == scheduler == CPU on "
        f"{len(base)} requests, {sum(map(len, base))} tokens; batch "
        f"4 -> 2 re-traced with tokens kept")
    del params
    release()


def phase_families(kernel_rows):
    import torch
    release()
    torch.backends.cuda.matmul.allow_tf32 = True
    results, walls = {}, {}
    for arch, layers, serve_kw, traffic in FAMILIES:
        t0 = time.perf_counter()
        results[arch] = serve_family(arch, layers, serve_kw, traffic,
                                     kernel_rows)
        walls[arch] = round(time.perf_counter() - t0, 1)
    for arch, layers, serve_kw, traffic in SERVED_ONLY:
        t0 = time.perf_counter()
        serve_family(arch, layers, serve_kw, traffic, kernel_rows,
                     steady=False)
        walls[arch] = round(time.perf_counter() - t0, 1)
    log("families table: " + json.dumps(results))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, _, _, _ in FAMILIES:
        t0 = time.perf_counter()
        family_equality(arch)
        walls[arch + " equality"] = round(time.perf_counter() - t0, 1)
    log(f"families walls (s): {json.dumps(walls)}")
    release()


# --------------------------------------------------------------------------
# phase cross: whisper-small and llama-3.2-vision-90b served lock-step,
# whisper scoring on the flash kernel's bidirectional and cross forms
# --------------------------------------------------------------------------

# (arch, decoder layers kept (None: the published depth), requests, prompt
# tokens, new tokens); the VLM's 100 layers are 87.67 B params (175 GB in
# bf16): cut to two of its 20 super-blocks (8 attn + 2 cross, 10.66 B)
CROSS_SERVE = (("whisper-small", None, 8, 64, 32),
               ("llama-3.2-vision-90b", 10, 8, 128, 32))
# equality depth: whisper 2 encoder + 2 decoder layers, the VLM one
# super-block (4 attn + its cross layer)
CROSS_EQ_LAYERS = {"whisper-small": 2, "llama-3.2-vision-90b": 5}
# batches the CPU arm of the equality serves (the card's arms serve two):
# the VLM's reads 25.7 GB of f32 weights a step on the host
CROSS_EQ_CPU_BATCHES = {"whisper-small": 2, "llama-3.2-vision-90b": 1}
WHISPER_SCORE = (4, 128, 1500)       # audio, transcript tokens, frames
WHISPER_SCORE_CALLS = 6
WHISPER_SCORE_TOL = 1e-4             # f32 scores (phase 6's rule)


def cross_config(arch, layers, **kw):
    cfg = family_config(arch, layers, **kw)
    if cfg.enc_layers and layers is not None:
        cfg = dataclasses.replace(cfg, enc_layers=layers)
    return cfg


def seed_gates(cfg, params, seed=3):
    """Set every ``cross`` slot's gate (zero at init, which would hide
    the vision states from the tokens) to seeded values in [0.3, 1]."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    for slot, kind in zip(params["blocks"], cfg.block_pattern):
        if kind == "cross":
            g = slot["gate"]
            g.copy_(torch.from_numpy(rng.uniform(0.3, 1.0, tuple(g.shape))
                                     .astype(np.float32)).to(g))


def side_input(cfg, batch, seed, device="cuda"):
    """Seeded side input on ``device``: Whisper's frame embeddings (f32)
    or the VLM's vision states (the model's dtype), [batch, T, d]."""
    import torch
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                    generator=gen, device=device)
    if cfg.enc_layers:
        return "frontend_embeds", x
    return "cross_states", x.to(getattr(torch, cfg.dtype))


def reproject_ms(cfg, params, states):
    """Milliseconds a decode step spends re-projecting the cross K/V from
    ``states`` [B, T, d] (every cross-attention, as the reference does
    each step; not cached), by CUDA events around its products."""
    import torch
    from repro_torch.models.layers import dense
    ps = [(slot["cross"], kind) for slot, kind in
          zip(params["blocks"], cfg.block_pattern)
          if kind in ("cross", "dec_attn_cross")]

    def run():
        with torch.no_grad():
            for p, _ in ps:
                for i in range(cfg.n_pattern_blocks):
                    dense(states, p["wk"][i])
                    dense(states, p["wv"][i])
    return time_ms(run, 10)


def cross_profile(run, steps_of):
    """One profiler window over a captured batch (``run()``): device ms a
    decode step by kernel class (matrix products: cuBLAS's nvjet / gemm
    kernels; copies; the rest: the chunked attention's and the norms'
    elementwise and reduction kernels) and the six kernels that take the
    most device time, a step."""
    out, _, kernels = profiled(run)
    steps = steps_of(out)
    classes = {"products": 0.0, "copies": 0.0, "rest": 0.0}
    top = []
    for name, us, _ in kernels:
        key = name.lower()
        if any(x in key for x in ("nvjet", "gemm", "xmma", "cutlass",
                                  "gemv")):
            classes["products"] += us
        elif "memcpy" in key or "copy" in key:
            classes["copies"] += us
        else:
            classes["rest"] += us
        top.append((us, re.sub(r"\(.*$", "", name)[:70]))
    top.sort(reverse=True)
    return ({k: round(v / steps / 1e3, 4) for k, v in classes.items()},
            [(n, round(us / steps / 1e3, 4)) for us, n in top[:6]])


def serve_cross(arch, layers, n, prompt, new):
    """One side-input family at published width, bf16 random weights:
    ``ServingEngine.run_batch`` co-executed and with ``use_terra=False``
    (equal greedy tokens), then the co-executed engine captured against
    one made under ``disable_jit()``, in turns: time to the first token
    (encode + prefill), decode ms a step, busy share, peak memory."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServingEngine

    cfg = cross_config(arch, layers)
    release()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    seed_gates(cfg, params)
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    log(f"cross {arch}: {n_params / 1e9:.4f} B params ({n_params * 2 / 1e9:.2f}"
        f" GB bf16), {cfg.n_layers} decoder layers, {cfg.enc_layers} encoder "
        f"layers, init {time.perf_counter() - t0:.1f} s, {gib_allocated()} GiB"
        f" allocated")
    max_len = prompt + new + 8
    toks = {}
    for terra in (True, False):
        eng = ServingEngine(cfg, params, max_len=max_len, use_terra=terra)
        for b in range(2):          # the second batch replays the graphs
            kw, side = side_input(cfg, n, 100 + b)
            reqs = make_requests(cfg, n, 100 + b, prompt, prompt, new, new)
            eng.run_batch(reqs, **{kw: side})
            toks[(terra, b)] = [r.out_tokens for r in reqs]
            check(all(len(r.out_tokens) == new for r in reqs),
                  f"{arch}: a request got fewer than {new} tokens")
        if terra:
            check_captured(f"{arch} lock-step decode", eng.terra.engine)
        ctx = eng.decode.ctx
        log(f"cross {arch} {'terra' if terra else 'use_terra=False'} serve "
            f"steps: {json.dumps(ctx.stats)}")
        check(ctx.stats["graphs"] > 0 and ctx.stats["replays"] > 0,
              f"{arch}: the serving steps were not captured")
        eng.close()
        del eng
    for b in range(2):
        check(toks[(True, b)] == toks[(False, b)],
              f"{arch}: greedy tokens differ co-executed vs use_terra=False "
              f"in batch {b}")
    log(f"cross {arch}: greedy tokens equal co-executed and use_terra=False "
        f"({2 * n} requests, {2 * n * new} tokens)")

    _, states = side_input(cfg, n, 7)
    if cfg.enc_layers:
        with torch.no_grad():
            from repro_torch.models import transformer as T
            states = T.encode(cfg, params, states)
    re_ms = reproject_ms(cfg, params, states)
    log(f"cross {arch}: re-projecting the cross K/V from {tuple(states.shape)}"
        f" states takes {re_ms:.4f} ms a decode step (CUDA events)")
    del states

    engines, arms, side_ms = {}, {}, {}
    for name in ("captured", "eager"):
        with arm_context(name == "eager"):
            engines[name] = ServingEngine(cfg, params, max_len=max_len)
        side_ms[name] = {"ttft": [], "decode": []}

        def run(eng=engines[name], jit_off=name == "eager", seed=[300],
                rec=side_ms[name]):
            seed[0] += 1
            kw, side = side_input(cfg, n, seed[0])
            reqs = make_requests(cfg, n, seed[0], prompt, prompt, new,
                                 new)
            st0 = dict(eng.stats)
            with arm_context(jit_off):
                eng.run_batch(reqs, **{kw: side})
            steps = eng.stats["decode_steps"] - st0["decode_steps"]
            rec["ttft"].append(1e3 * (eng.stats["prefill_time"]
                                      - st0["prefill_time"]))
            rec["decode"].append(1e3 * (eng.stats["decode_time"]
                                        - st0["decode_time"]) / steps)
            return steps
        for _ in range(2):                  # tracing, warm-up, capture
            run()
        for v in side_ms[name].values():
            v.clear()
        arms[name] = (run, engines[name].terra.engine.capture)
    out = capture_turns(f"{arch} lock-step", "decode_step", arms)
    eng = engines["captured"]
    if eng.encode is not None:      # the encoder alone, replayed
        _, frames = side_input(cfg, n, 9)
        out["encode_ms"] = round(time_ms(
            lambda: eng.encode(eng.params, frames), 5), 3)
    by_class, top = cross_profile(arms["captured"][0], lambda steps: steps)
    out["captured"]["device_ms_by_class_per_step"] = by_class
    out["captured"]["top_kernels_ms_per_step"] = top
    for name, rec in side_ms.items():
        # the arm's three turns (later batches ran under the profiler)
        ttft, dec = rec["ttft"][:3], rec["decode"][:3]
        out[name]["ttft_ms"] = round(float(np.median(ttft)), 3)
        out[name]["decode_ms_per_step"] = round(float(np.median(dec)), 3)
        out[name]["ttft_turns_ms"] = [round(t, 3) for t in ttft]
        out[name]["decode_turns_ms"] = [round(t, 3) for t in dec]
        out[name]["tokens_per_s"] = round(
            n * 1e3 / out[name]["decode_ms_per_step"], 1)
    out["reproject_ms_per_step"] = round(re_ms, 4)
    check_captured(f"{arch} timed decode", engines["captured"].terra.engine)
    check_eager(f"{arch} timed decode", engines["eager"].terra.engine)
    for eng in engines.values():
        eng.close()
    del params, engines, arms, run
    release()
    return out


def cross_equality(arch):
    """Full width at CROSS_EQ_LAYERS depth, float32, TF32 off: greedy
    tokens of two batches of four same-length requests equal across
    ServingEngine co-executed and ``use_terra=False``, each captured and
    under ``disable_jit()``, and on the CPU (CROSS_EQ_CPU_BATCHES).  For Whisper, one decode step
    with the encoder states and one without (as the reference's
    ``run_batch`` decodes) give different tokens."""
    import numpy as np
    import torch
    from repro_torch.core.pytree import tree_map
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServingEngine

    release()
    cfg = cross_config(arch, CROSS_EQ_LAYERS[arch], dtype="float32",
                       param_dtype="float32")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(1))
    seed_gates(cfg, params)
    rng = np.random.RandomState(5)
    batches = [[rng.randint(0, cfg.vocab, 24).astype(np.int32)
                for _ in range(4)] for _ in range(2)]
    news = [12, 8, 12, 10]
    sides = [side_input(cfg, 4, 20 + b) for b in range(2)]

    def serve(device, use_terra, params, eager=False, n_batches=2):
        with arm_context(eager):
            eng = ServingEngine(cfg, params, max_len=48, use_terra=use_terra,
                                device=device)
            out = []
            for prompts, (kw, side) in zip(batches[:n_batches], sides):
                reqs = [Request(prompt=p, max_new_tokens=m, arrival_time=0.0)
                        for p, m in zip(prompts, news)]
                eng.run_batch(reqs, **{kw: side.to(device or "cuda")})
                out.append([r.out_tokens for r in reqs])
        label = (f"{arch} {'terra' if use_terra else 'use_terra=False'}"
                 f"{' disable_jit' if eager else ''}")
        if device is None and use_terra:
            (check_eager if eager else check_captured)(label,
                                                       eng.terra.engine)
        eng.close()
        return out

    arms = {}
    for terra in (True, False):
        for eager in (False, True):
            arms[(terra, eager)] = serve(None, terra, params, eager)
    n_cpu = CROSS_EQ_CPU_BATCHES[arch]
    arms["cpu"] = serve("cpu", True, tree_map(lambda t: t.cpu(), params),
                        n_batches=n_cpu)
    base = arms[(True, False)]
    for name, toks in arms.items():
        check(toks == base[:len(toks)], f"{arch}: greedy tokens differ, "
              f"co-executed captured {base} vs {name} {toks}")
    log(f"cross {arch} equality at {cfg.n_layers} layers (f32): co-executed "
        f"== use_terra=False, captured == disable_jit() on 2 x 4 requests, "
        f"{sum(len(t) for b in base for t in b)} tokens, == CPU on {n_cpu}")
    if cfg.enc_layers:
        kw, fe = sides[0]
        prompts = torch.from_numpy(np.stack(batches[0])).cuda()
        with torch.no_grad():
            logits, cache = M.prefill(cfg, params, prompts, 48,
                                      frontend_embeds=fe)
            tok = torch.argmax(logits, -1)[:, None]
            states = T.encode(cfg, params, fe)
            # decode_step writes no cache in place: both read the prefill's
            with_audio, _ = M.decode_step(cfg, params, cache, tok,
                                          cross_states=states)
            without, _ = M.decode_step(cfg, params, cache, tok)
        a, b = with_audio.argmax(-1).tolist(), without.argmax(-1).tolist()
        log(f"cross {arch}: a decode step with the encoder states gives "
            f"tokens {a}, without them {b}")
        check(a != b, f"{arch}: decode ignores the encoder states")
    del params
    release()


def attention_forms(engine):
    """(Sq, Skv, causal) -> the count of ``kernel.attention`` nodes in an
    engine's compiled graph (Skv from the node that feeds k)."""
    import collections
    otg = engine.gp.otg
    forms = collections.Counter()
    for n in otg.nodes.values():
        if n.kind == "op" and n.op_name == "kernel.attention":
            src = n.srcs[1]
            skv = (otg.nodes[src[1]].out_avals[src[2]].shape[1]
                   if src[0] == "node" else None)
            forms[(n.out_avals[0].shape[1], skv,
                   bool(dict(n.attrs)["causal"]))] += 1
    return forms


def whisper_score_inputs(cfg, i, device="cuda"):
    """Seeded transcripts [4, 128] (numpy) and frame embeddings [4, 1500,
    d] (float32, on ``device``: the program's feed; the same values on
    every device)."""
    import numpy as np
    import torch
    B, S, T = WHISPER_SCORE
    rng = np.random.RandomState(2000 + i)
    tok = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    audio = rng.randn(B, T, cfg.d_model).astype(np.float32)
    return tok, torch.from_numpy(audio).to(device)


def whisper_score_call(step, cfg, i, device="cuda"):
    import numpy as np
    B = WHISPER_SCORE[0]
    scores, order, last = step(*whisper_score_inputs(cfg, i, device))
    last = last.numpy()
    check(scores.shape == (B,) and np.isfinite(scores).all()
          and (scores < 0).all(), f"bad whisper scores {scores}")
    check(last.shape == (B, cfg.vocab) and np.isfinite(last).all(),
          f"bad whisper next-token logits {last.shape}")
    check(sorted(order.tolist()) == list(range(B)), f"bad ranking {order}")
    return scores


def whisper_scoring(kernel_rows):
    """whisper-small at full width and depth scoring 4 audio x 1500
    frames against 128-token transcripts through ``function`` with the
    default ``optimize="all"`` (the kernels pass): 36 substitutions a
    graph in three forms, flash launches = 36 x compiled calls (counters
    zeroed just before, read just after), the unfused program and the
    kernel one in turns (bf16).  Then float32 with TF32 off: the kernel
    program's scores against the unfused program's on the card and
    against the CPU, within WHISPER_SCORE_TOL."""
    import numpy as np
    import torch
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.models import model as M

    B, S, T = WHISPER_SCORE
    cfg = get_config("whisper-small")
    n_attn = cfg.n_layers + 2 * cfg.n_layers    # encoder, causal, cross
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    step = whisper_score_program(core, cfg, params, B, S, T)
    peak = {"traced": (0, 0), "compiled": (0, 0)}  # (peak, held before)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WHISPER_SCORE_CALLS):
        traced = step.stats.get("traced_iterations", 0)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        whisper_score_call(step, cfg, i)
        step.wait()
        kind = ("traced" if step.stats["traced_iterations"] > traced
                else "compiled")
        peak[kind] = max(peak[kind], (torch.cuda.max_memory_allocated(),
                                      held))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = step.stats
    compiled = st["iterations"] - st["traced_iterations"]
    forms = attention_forms(step.engine)
    log("cross whisper scoring counters: " + json.dumps(
        {k: st.get(k) for k in ("iterations", "traced_iterations",
                                 "retraces", "replays", "graph_versions",
                                 "kernels_substituted", "feeds_folded")}
        | {"phase": step.phase}))
    log(f"cross whisper scoring: launches {json.dumps(counts)}; "
        f"kernel.attention forms (Sq, Skv, causal): "
        f"{json.dumps({str(k): v for k, v in forms.items()})}; "
        f"{WHISPER_SCORE_CALLS} calls of {B} x {S} tokens against {B} x {T} "
        f"frames in {wall:.2f} s (includes tracing); peak device memory "
        f"{peak['traced'][0] / 2**30:.2f} GiB in a traced call, "
        f"{peak['compiled'][0] / 2**30:.2f} GiB in a compiled call "
        f"({peak['traced'][1] / 2**30:.2f} and "
        f"{peak['compiled'][1] / 2**30:.2f} GiB held as each began)")
    check(step.phase == "co-execution", f"phase {step.phase}")
    check(st["graph_versions"] == 1 and st["kernels_substituted"] == n_attn,
          f"kernels_substituted {st['kernels_substituted']} != {n_attn} "
          f"(graph_versions {st['graph_versions']})")
    check(forms == {(T, T, False): cfg.n_layers, (S, S, True): cfg.n_layers,
                    (S, T, False): cfg.n_layers},
          f"kernel.attention forms {dict(forms)}")
    check(compiled > 0, "no call ran the compiled graph")
    check(counts["flash_attention"] == compiled * n_attn,
          f"flash_attention launches {counts['flash_attention']} != "
          f"{compiled} compiled calls x {n_attn}")
    # one launch of each form a layer a compiled call (forms checked above)
    for row in kernel_rows:
        if row["name"].startswith("flash_attention[whisper-small"):
            row["launches"] = compiled * cfg.n_layers

    unfused = whisper_score_program(core, cfg, params, B, S, T,
                                    optimize="safe")
    arms = {"kernel": step, "unfused": unfused}
    for i in range(3):                    # tracing + co-execution entry
        whisper_score_call(unfused, cfg, i)
    got = {}
    for name in ("unfused", "kernel", "kernel", "unfused"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[name] = [whisper_score_call(arms[name], cfg, 100 + i)
                     for i in range(4)]
        arms[name].wait()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 4 * 1e3
        log(f"cross whisper scoring turn {name}: {ms:.1f} ms a call "
            f"({B * S / ms * 1e3:.0f} transcript tokens/s)")
    diff = max(float(abs(a - b).max())
               for a, b in zip(got["kernel"], got["unfused"]))
    log(f"cross whisper scoring bf16, kernel vs unfused: max abs diff "
        f"{diff:.3e} (bf16 rounding; checked in float32 below)")
    for fn in arms.values():
        fn.close()
    del step, unfused, arms, params
    release()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(1))
    scores = {}
    for name, opt in (("kernel", None), ("unfused", "safe")):
        kw = {} if opt is None else {"optimize": opt}
        fn = whisper_score_program(core, cfg, params, B, S, T, **kw)
        before = read_counts()["flash_attention"]
        scores[name] = [whisper_score_call(fn, cfg, i) for i in range(4)]
        fn.wait()
        launched = read_counts()["flash_attention"] - before
        log(f"cross whisper scoring f32 arm {name}: phase {fn.phase}, "
            f"kernels_substituted {fn.stats.get('kernels_substituted')}, "
            f"flash launches {launched}")
        check(fn.phase == "co-execution", f"{name} phase {fn.phase}")
        if name == "kernel":
            check(launched == n_attn * (4 - fn.stats["traced_iterations"])
                  and launched > 0, f"f32 kernel arm launched {launched}")
        fn.close()
    cpu = whisper_score_program(core, cfg, tree_map(lambda t: t.cpu(),
                                                    params), B, S, T,
                                optimize="safe", device="cpu")
    t0 = time.perf_counter()
    scores["cpu"] = whisper_score_call(cpu, cfg, 3, device="cpu")
    cpu.close()
    log(f"cross whisper scoring f32 on the CPU: one call in "
        f"{time.perf_counter() - t0:.1f} s")
    d_unfused = max(float(abs(a - b).max()) for a, b in
                    zip(scores["kernel"][2:], scores["unfused"][2:]))
    d_cpu = float(abs(scores["kernel"][3] - scores["cpu"]).max())
    log(f"cross whisper scoring f32 (compiled calls): kernel vs unfused max "
        f"abs diff {d_unfused:.3e}, kernel vs CPU {d_cpu:.3e} (tol "
        f"{WHISPER_SCORE_TOL})")
    check(d_unfused <= WHISPER_SCORE_TOL and d_cpu <= WHISPER_SCORE_TOL,
          f"whisper f32 scores differ: {d_unfused:.3e}, {d_cpu:.3e}")
    del params
    release()


def phase_cross(kernel_rows):
    import torch
    release()
    torch.backends.cuda.matmul.allow_tf32 = True
    results, walls = {}, {}
    t0 = time.perf_counter()
    whisper_scoring(kernel_rows)
    walls["whisper scoring"] = round(time.perf_counter() - t0, 1)
    torch.backends.cuda.matmul.allow_tf32 = True
    for arch, layers, n, prompt, new in CROSS_SERVE:
        t0 = time.perf_counter()
        results[arch] = serve_cross(arch, layers, n, prompt, new)
        walls[arch] = round(time.perf_counter() - t0, 1)
    log("cross table: " + json.dumps(results))
    for arch, arms in results.items():
        a, b = arms["eager"], arms["captured"]
        log(f"cross {arch}: TTFT eager {a['ttft_ms']} -> captured "
            f"{b['ttft_ms']} ms, decode {a['decode_ms_per_step']} -> "
            f"{b['decode_ms_per_step']} ms a step, busy {a['busy_share']} -> "
            f"{b['busy_share']}, peak {a['peak_gib']} -> {b['peak_gib']} GiB")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in CROSS_EQ_LAYERS:
        t0 = time.perf_counter()
        cross_equality(arch)
        walls[arch + " equality"] = round(time.perf_counter() - t0, 1)
    log(f"cross walls (s): {json.dumps(walls)}")
    release()


# --------------------------------------------------------------------------
# phases obs and persist (the observability layer, warm boots, checkpoints)
# --------------------------------------------------------------------------

OBS_SLOTS, OBS_PROMPT, OBS_NEW = 8, (96, 128), 48
OBS_PROFILED_STEPS = 3          # decode steps each under its own profiler
OBS_SCORE_PROFILE = 2           # function(profile=N) of the scoring program
_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+=\"[^\"]*\"(,[a-zA-Z_]+="
    r"\"[^\"]*\")*\})? [-+0-9.eEnaif]+$")


def obs_requests(cfg, seed):
    """OBS_SLOTS requests, arriving now (the scheduler's clock), prompts
    OBS_PROMPT tokens, OBS_NEW new tokens each."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.RandomState(seed)
    return [Request(prompt=rng.randint(0, cfg.vocab, int(rng.randint(
        OBS_PROMPT[0], OBS_PROMPT[1] + 1))).astype(np.int32),
        max_new_tokens=OBS_NEW) for _ in range(OBS_SLOTS)]


def decode_window(sched, reqs):
    """Serve ``reqs`` (one batch: every slot busy); -> (ms a decode step
    over the steps after the first two scheduler steps, their count)."""
    for r in reqs:
        sched.submit(r)
    sched.run(max_steps=2)                  # the prefill, a first decode
    st0 = sched.stats["decode_steps"]
    t0 = time.perf_counter()
    sched.run()                             # drains and waits on the card
    dt = time.perf_counter() - t0
    n = sched.stats["decode_steps"] - st0
    return dt / n * 1e3, n


def profile_joins(events):
    """(SegmentProfile, RunnerComplete wall) pairs: the profile joined to
    its SegmentDispatch on (iter, kind, index), that to its closure's
    RunnerComplete on seq (the report CLI's join)."""
    from repro_torch.core.events import types as T
    seq = {(e.iter_id, e.kind, e.index): e.seq for e in events
           if type(e) is T.SegmentDispatch}
    wall = {e.seq: e.wall for e in events if type(e) is T.RunnerComplete}
    out = []
    for e in events:
        if type(e) is T.SegmentProfile:
            s = seq.get((e.iter_id, e.kind, e.index))
            out.append((e, wall.get(s)))
    return out


def check_profiles(label, events, kernel_ops):
    """Every sampled segment holding ``kernel_ops`` names them, and its
    CUDA-event device time is positive and at most its closure's host
    wall; -> the sampled profiles that hold them."""
    pairs = [(e, w) for e, w in profile_joins(events)
             if set(kernel_ops) & set(e.kernels)]
    check(pairs, f"{label}: no sampled segment names {kernel_ops}")
    for e, w in pairs:
        check(set(kernel_ops) <= set(e.kernels),
              f"{label}: {e.kind}[{e.index}] kernels {e.kernels}")
        check(w is not None and 0.0 < e.device <= w,
              f"{label}: {e.kind}[{e.index}] device {e.device:.6f} s, "
              f"host wall {w}")
    return [e for e, _ in pairs]


def check_timeline(path, retired):
    """A Chrome/Perfetto export: every track's timestamps monotone, every
    retired request's flow complete (start, step, finish)."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    tracks, flows = {}, {}
    for e in evs:
        if e["ph"] == "M":
            continue
        tracks.setdefault((e["pid"], e["tid"]), []).append(e["ts"])
        if e.get("cat") == "flow" and str(e["id"]).startswith("req:"):
            flows.setdefault(e["id"], []).append(e["ph"])
    for track, tss in tracks.items():
        check(tss == sorted(tss), f"{path}: track {track} not monotone")
    check(set(flows) == {f"req:{r}" for r in retired},
          f"{path}: flows {len(flows)} for {len(retired)} retired requests")
    for fid, phs in flows.items():
        check(phs[0] == "s" and phs[-1] == "f" and "t" in phs
              and phs.count("s") == 1 and phs.count("f") == 1,
              f"{path}: flow {fid} {phs}")
    return len(evs)


def scrape_metrics(registry):
    """GET /metrics from a MetricsServer on loopback; every line parses as
    Prometheus text; -> the metric names."""
    import urllib.request
    from repro_torch.obs.http import MetricsServer
    srv = MetricsServer(registry)
    try:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        srv.stop()
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("# TYPE"):
            continue
        check(_PROM_LINE.match(line), f"/metrics line {line!r}")
        names.add(line.split("{")[0].split(" ")[0])
    return names


def pct(a, q: str) -> float:
    """Percentile ``q`` ("p50") by the registry's rank rule: the sample of
    rank ceil(q / 100 * n)."""
    import numpy as np
    return float(np.percentile(a, float(q[1:]), method="inverted_cdf"))


def request_clock(reqs):
    """(TTFT ms, TPOT ms) a request by the scheduler's own clock."""
    import numpy as np
    ttft = [(r.first_token_time - r.arrival_time) * 1e3 for r in reqs]
    tpot = [(r.finish_time - r.first_token_time) * 1e3
            / (len(r.out_tokens) - 1) for r in reqs]
    return np.asarray(ttft), np.asarray(tpot)


def phase_obs(out_dir):
    """llama3-8b serving with the observability layer attached, and the
    scoring program through ``function(profile=N)``."""
    import numpy as np
    import torch
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.core.events import (JsonlSink, RequestTraceProcessor,
                                         load_jsonl)
    from repro_torch.core.events import types as T
    from repro_torch.models import model as M
    from repro_torch.obs import (MetricsProcessor, TraceViewerExporter,
                                 report)
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg = get_config("llama3-8b")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    sched = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                        **SERVE_KW)
    decode_window(sched, obs_requests(cfg, 0))        # tracing + capture

    os.makedirs(out_dir, exist_ok=True)
    jsonl = os.path.join(out_dir, "obs_serving.jsonl")
    open(jsonl, "w").close()
    registry = sched.enable_metrics()
    procs = [p for p in sched.events._procs
             if isinstance(p, MetricsProcessor)]
    tracer, sink = RequestTraceProcessor(), JsonlSink(jsonl)
    viewer = TraceViewerExporter(jsonl + ".perfetto")
    procs += [tracer, sink, viewer]
    graphs0 = sched._tf.engine.capture.stats["graphs"]
    # counts of this path only: zeroed just before it, read just after
    zero_counts()
    st0 = sched.stats
    served, turns, toks = [], {}, {}
    # everything off, on (the processors attached) and sampled (every
    # step profiled as well), in turns; each arm's best turn is its time
    for arm in ("off", "on", "sampled", "sampled", "on", "off"):
        for p in procs:
            sched.events.detach(p)
            if arm != "off":
                sched.events.attach(p)
        sched.set_profile(1 if arm == "sampled" else 0)
        reqs = obs_requests(cfg, 1)
        turns.setdefault(arm, []).append(decode_window(sched, reqs))
        toks.setdefault(arm, []).append([r.out_tokens for r in reqs])
        if arm != "off":
            served += reqs
    for p in procs:
        sched.events.attach(p)
    arms = {a: min(t) for a, t in turns.items()}
    # the latency percentiles printed below: these 32 requests (the
    # profiler windows next stretch their requests' token gaps)
    snap = registry.snapshot()["histograms"]
    ttft, tpot = request_clock(served)
    # single sampled decode steps, each under its own profiler window
    sched.set_profile(1)
    reqs = obs_requests(cfg, 2)
    for r in reqs:
        sched.submit(r)
    sched.run(max_steps=3)
    per_step = []
    for _ in range(OBS_PROFILED_STEPS):
        n0 = len(viewer.events)
        paged_ms = sum(us for key, us, _ in
                       profiled(lambda: sched.run(max_steps=1))[2]
                       if "paged" in key) / 1e3
        step = [e for e in viewer.events[n0:]
                if type(e) is T.SegmentProfile
                and "kernel.slot_decode_paged" in e.kernels]
        check(len(step) == 1, f"obs: {len(step)} sampled decode steps in a "
              f"profiled scheduler step")
        per_step.append((step[0].device * 1e3, paged_ms))
        check(step[0].device * 1e3 >= paged_ms > 0,
              f"obs: CUDA-event device {step[0].device * 1e3:.4f} ms < the "
              f"profiler's paged kernels {paged_ms:.4f} ms in its step")
    sched.run()
    served += reqs
    sched.set_profile(0)
    counts = read_counts()
    st = sched.stats
    captured = sched._tf.engine.capture.stats["graphs"] - graphs0
    sched.events.detach(viewer)
    sched.events.detach(sink)
    sched.events.detach(tracer)
    sink.close()
    viewer.close()
    compiled = ((st["iterations"] - st["traced_iterations"])
                - (st0["iterations"] - st0["traced_iterations"]))
    check(counts["paged_attention"] == compiled * cfg.n_layers
          and compiled > 0, f"obs paged launches {counts['paged_attention']}"
          f" != {compiled} compiled decode steps x {cfg.n_layers}")
    check(all(t == toks["off"][0] for ts in toks.values() for t in ts),
          "obs: greedy tokens with the observability layer on differ from "
          "the tokens with it off")
    events = list(viewer.events)
    profs = check_profiles("obs serving", events,
                           ("kernel.slot_decode_paged",))
    gen = sum(len(r.out_tokens) for r in served)
    hist = registry.histograms
    check(hist["ttft_ms"].count == len(served),
          f"obs: registry TTFT count {hist['ttft_ms'].count} != "
          f"{len(served)} requests")
    check(hist["ttft_ms"].count + hist["token_latency_ms"].count == gen,
          f"obs: registry token count != {gen} tokens generated")
    for r in served:
        rec = tracer.trace(r.rid)
        check(rec and rec[0]["type"] == "RequestSubmit"
              and rec[-1]["type"] == "RequestRetire"
              and sum(x["type"] == "RequestToken" for x in rec)
              == len(r.out_tokens), f"obs: request {r.rid} trace incomplete")
    names = scrape_metrics(registry)
    check({"terra_ttft_ms_count", "terra_token_latency_ms_bucket",
           "terra_segment_device_us_count"} <= names,
          f"obs: /metrics lacks the serving histograms: {sorted(names)[:8]}")
    loaded = load_jsonl(jsonl)
    check(len(loaded) == len(events),
          f"obs: JSONL holds {len(loaded)} of {len(events)} events")
    retired = [e.rid for e in events if type(e) is T.RequestRetire]
    t0 = time.perf_counter()
    check(report.main([jsonl]) == 0, "obs.report failed")
    n_trace = check_timeline(jsonl + ".trace.json", retired)
    report_s = time.perf_counter() - t0
    log("obs table: " + json.dumps({
        "decode_ms_a_step": {a: round(v[0], 4) for a, v in arms.items()},
        "turns_ms": {a: [round(v[0], 4) for v in t]
                     for a, t in turns.items()},
        "steps": {a: v[1] for a, v in arms.items()},
        "tracing_ratio_on": round(arms["off"][0] / arms["on"][0], 4),
        "tracing_ratio_sampled": round(arms["off"][0] / arms["sampled"][0],
                                       4),
        "ttft_ms_registry": {q: round(snap["ttft_ms"][q], 3)
                             for q in ("p50", "p99")},
        "ttft_ms_scheduler": {q: round(pct(ttft, q), 3)
                              for q in ("p50", "p99")},
        "tpot_ms_registry": {q: round(snap["token_latency_ms"][q], 3)
                             for q in ("p50", "p99")},
        "tpot_ms_scheduler": {q: round(pct(tpot, q), 3)
                              for q in ("p50", "p99")},
        "sampled_decode_device_ms": round(float(np.median(
            [e.device for e in profs])) * 1e3, 4),
        "sampled_decode_dispatch_ms": round(float(np.median(
            [e.dispatch for e in profs])) * 1e3, 4),
        "profiled_steps_device_vs_paged_ms": [
            [round(a, 4), round(b, 4)] for a, b in per_step],
        "sampled_segments": len(profs),
        "graphs_captured_in_window": captured,
        "events": len(events), "trace_events": n_trace,
        "report_s": round(report_s, 2), "requests": len(served),
        "tokens": gen, "launches": counts}))
    sched.close()
    del sched
    release()

    # the scoring program through function(profile=N, optimize="all")
    from repro_torch.core.events import ListProcessor
    step = llama_score_program(core, cfg, params, SCORE_BATCH, SCORE_SEQ,
                               optimize="all", profile=OBS_SCORE_PROFILE)
    lp = step.engine.events.attach(ListProcessor())
    zero_counts()
    kinds, cap = [], step.engine.capture.stats
    for i in range(6):
        before = (step.stats.get("traced_iterations", 0), cap["warmups"],
                  cap["graphs"])
        score_call(step, cfg, i)
        step.wait()
        # what each call ran: traced, the graphs' eager warm-up, their
        # capture (a sampled capture times the capture), or replays
        kinds.append("traced" if step.stats["traced_iterations"] > before[0]
                     else "capture" if cap["graphs"] > before[2]
                     else "warm-up" if cap["warmups"] > before[1]
                     else "replay")
    counts = read_counts()
    st = step.stats
    compiled = st["iterations"] - st["traced_iterations"]
    check(step.phase == "co-execution", f"obs scoring phase {step.phase}")
    check(counts["flash_attention"] == compiled * cfg.n_layers
          and counts["rmsnorm"] == compiled * (2 * cfg.n_layers + 1)
          and compiled > 0, f"obs scoring launches {counts} for {compiled} "
          f"compiled calls")
    profs = check_profiles("obs scoring", lp.events,
                           ("kernel.attention", "kernel.rms_norm"))
    log("obs scoring segments (sampled every "
        f"{OBS_SCORE_PROFILE} calls):\n" + report.segment_table(lp.events))
    log("obs scoring: " + json.dumps({
        "sampled_segments_with_kernels": len(profs),
        "calls": kinds, "sampled_calls": [kinds[e.iter_id] for e in profs],
        "device_ms": [round(e.device * 1e3, 3) for e in profs],
        "dispatch_ms": [round(e.dispatch * 1e3, 3) for e in profs],
        "launches": counts, "compiled_calls": compiled}))
    step.close()
    del step, params
    release()


# ---- persist: boots and a scheduler checkpoint in child processes --------

PERSIST_REQS = (12, 16, 256, 32, 64)    # phase 3's traffic
PERSIST_FIRST = (4, 16, 256, 16, 32)    # each boot's first requests
PERSIST_SCORE_CALLS = 4
PERSIST_CKPT_STEPS = 24                 # scheduler steps before the save
BOOT_KEYS = ("retraces", "segments_recompiled", "warm_families",
             "aot_loads", "artifact_hits", "artifact_misses",
             "artifacts_stored", "traced_iterations", "iterations")


class _FirstSkeleton:
    """A processor that keeps the clock of the first co-executed
    iteration's start (the time to the co-execution phase)."""

    def __init__(self):
        self.ts = None

    def process(self, e):
        if self.ts is None and type(e).__name__ == "IterationStart" \
                and e.mode == "skeleton":
            self.ts = e.ts

    def close(self):
        pass


def persist_requests(cfg, which):
    n, lo, hi, nlo, nhi = PERSIST_FIRST if which == "first" \
        else PERSIST_REQS
    return make_requests(cfg, n, seed=5 if which == "first" else 0,
                         prompt_lo=lo, prompt_hi=hi, new_lo=nlo, new_hi=nhi)


def boot_child(cfg, params, out):
    """A boot: llama3-8b served by the co-executed paged scheduler (the
    first requests time the boot — a cold boot traces their first decode
    step, eager and unfused, a warm one hydrates it — then the equality
    set runs compiled in both), then scored through ``function`` with
    the kernels pass."""
    import repro_torch.core as core
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    sched = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                        **SERVE_KW)
    first = sched.events.attach(_FirstSkeleton())
    boot, reqs = persist_requests(cfg, "first"), persist_requests(cfg, "eq")
    zero_counts()
    t0 = time.perf_counter()
    for r in boot:
        r.arrival_time = t0
    sched.serve(boot)
    boot_wall = time.perf_counter() - t0
    sched.serve(reqs)
    st = sched.stats
    compiled = st["iterations"] - st["traced_iterations"]
    out["serve"] = {
        "tokens": [r.out_tokens for r in reqs],
        "boot_tokens": [r.out_tokens for r in boot],
        "wall_s": boot_wall,
        "ttft_s": min(r.first_token_time for r in boot) - t0,
        "coexec_s": None if first.ts is None else first.ts - t0,
        "stats": {k: st.get(k) for k in BOOT_KEYS},
        "launches_per_step": read_counts()["paged_attention"] / compiled,
        "capture": dict(sched._tf.engine.capture.stats)}
    sched.close()
    del sched
    release()

    step = llama_score_program(core, cfg, params, SCORE_BATCH, SCORE_SEQ,
                               optimize="all")
    first = step.engine.events.attach(_FirstSkeleton())
    zero_counts()
    scores, t0 = [], time.perf_counter()
    for i in range(PERSIST_SCORE_CALLS):
        scores.append(score_call(step, cfg, i).tolist())
        if i == 0:
            t_score = time.perf_counter() - t0
    step.wait()
    st = step.stats
    compiled = st["iterations"] - st["traced_iterations"]
    counts = read_counts()
    out["score"] = {
        "scores": scores, "first_score_s": t_score,
        "wall_s": time.perf_counter() - t0,
        "coexec_s": None if first.ts is None else first.ts - t0,
        "stats": {k: st.get(k) for k in BOOT_KEYS} | {"phase": step.phase},
        "launches_per_call": {k: counts[k] / compiled
                              for k in ("flash_attention", "rmsnorm")},
        "capture": dict(step.engine.capture.stats)}
    step.close()


def ckpt_child(cfg, params, out, path, role):
    """Role "ckpt": the equality set submitted, PERSIST_CKPT_STEPS
    scheduler steps, then a checkpoint; role "resume": the checkpoint
    restored into a fresh scheduler, run to the end.  Both warm-boot from
    the boots' store, so every decode step runs compiled, as the
    uninterrupted run's do after its first requests."""
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    ck = os.path.join(path, "sched")
    t0 = time.perf_counter()
    if role == "ckpt":
        sched = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                            **SERVE_KW)
        reqs = persist_requests(cfg, "eq")
        for r in reqs:
            sched.submit(r)
        sched.run(max_steps=PERSIST_CKPT_STEPS)
        out["in_flight"] = sched.pool.active_count
        out["queued"] = len(sched.queue)
        t0 = time.perf_counter()
        sched.checkpoint(ck)
        out["save_s"] = time.perf_counter() - t0
        out["bytes"] = dir_bytes(ck)
        out["tokens"] = {r.rid: list(r.out_tokens or []) for r in reqs}
    else:
        sched = ContinuousBatchingScheduler.restore(ck, cfg, params)
        out["restore_s"] = time.perf_counter() - t0
        tracked = {r.rid: r for _, r in sched.pool.active_items()}
        tracked.update({r.rid: r for r in sched.queue._queue})
        zero_counts()
        sched.run()
        out["tokens"] = {rid: r.out_tokens for rid, r in tracked.items()}
        out["paged_launches"] = read_counts()["paged_attention"]
    st = sched.stats
    out["stats"] = {k: st.get(k) for k in BOOT_KEYS} | {
        "checkpoint_restores": st.get("checkpoint_restores", 0)}
    sched.close()


def persist_child(role, path) -> int:
    """One child process of phase persist, under the parent's
    ``$TERRA_CACHE_DIR``: a boot, or one side of the scheduler
    checkpoint.  Prints one JSON line."""
    t_start = time.perf_counter()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("llama3-8b")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t_start}
    if role == "boot":
        boot_child(cfg, params, out)
    else:
        ckpt_child(cfg, params, out, path, role)
    out["proc_s"] = time.perf_counter() - t_start
    print(json.dumps(out), flush=True)
    return 0


def spawn_child(cache_dir, role, label, path=""):
    env = {**os.environ, "TERRA_CACHE_DIR": cache_dir}
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--persist-child", role, path], env=env, cwd=HERE,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"persist {label} exited {p.returncode}:"
          f"\n{p.stderr[-4000:]}")
    out = json.loads(p.stdout.strip().splitlines()[-1])
    out["spawn_s"] = wall
    return out


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def check_boots(cold, warm, art):
    import numpy as np
    for part in ("serve", "score"):
        c, w = cold[part]["stats"], warm[part]["stats"]
        check(c["artifacts_stored"] > 0 and c["warm_families"] == 0,
              f"persist cold {part}: {c}")
        check(w["retraces"] == 0 and w["segments_recompiled"] == 0
              and w["warm_families"] >= 1 and w["aot_loads"] >= 1
              and w["artifact_hits"] > 0, f"persist warm {part}: {w}")
    check(warm["serve"]["tokens"] == cold["serve"]["tokens"],
          "persist: warm tokens differ from the cold run's")
    # the calls both boots ran compiled (the cold boot traced its first,
    # eager and unfused, the warm one hydrated it)
    traced = cold["score"]["stats"]["traced_iterations"]
    cs, ws = (np.asarray(b["score"]["scores"]) for b in (cold, warm))
    diff = float(np.max(np.abs(ws[traced:] - cs[traced:])))
    check(diff <= 1e-6, f"persist: warm scores differ by {diff:.3e}")
    check(warm["serve"]["launches_per_step"]
          == cold["serve"]["launches_per_step"]
          and warm["score"]["launches_per_call"]
          == cold["score"]["launches_per_call"],
          "persist: kernel launches per compiled call differ warm vs cold")
    table = {"artifact_bytes": art, "max_abs_score_diff": diff,
             "traced_vs_hydrated_first_calls_diff": float(np.max(np.abs(
                 ws[:traced] - cs[:traced]))),
             "first_requests_tokens_equal":
                 warm["serve"]["boot_tokens"] == cold["serve"]["boot_tokens"]}
    for name, b in (("cold", cold), ("warm", warm)):
        table[name] = {
            "ttft_s": round(b["serve"]["ttft_s"], 3),
            "serve_coexec_s": b["serve"]["coexec_s"]
            and round(b["serve"]["coexec_s"], 3),
            "first_requests_wall_s": round(b["serve"]["wall_s"], 3),
            "first_score_s": round(b["score"]["first_score_s"], 3),
            "score_coexec_s": b["score"]["coexec_s"]
            and round(b["score"]["coexec_s"], 3),
            "score_wall_s": round(b["score"]["wall_s"], 3),
            "graphs_captured": (b["serve"]["capture"]["graphs"],
                                b["score"]["capture"]["graphs"]),
            "serve_stats": b["serve"]["stats"],
            "score_stats": b["score"]["stats"],
            "launches": (b["serve"]["launches_per_step"],
                         b["score"]["launches_per_call"]),
            "init_s": round(b["init_s"], 2), "proc_s": round(b["proc_s"], 2),
            "spawn_s": round(b["spawn_s"], 2)}
    log("persist boots: " + json.dumps(table))


def phase_persist():
    """Warm boots and a scheduler checkpoint (child processes sharing one
    ``$TERRA_CACHE_DIR``), then an engine checkpoint."""
    import tempfile
    import numpy as np
    from repro_torch import core, programs
    from repro_torch.configs import get_config
    release()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="terra-cache-") as cache, \
            tempfile.TemporaryDirectory(prefix="terra-ckpt-") as work:
        cold = spawn_child(cache, "boot", "cold boot")
        art = dir_bytes(cache)
        warm = spawn_child(cache, "boot", "warm boot")
        check_boots(cold, warm, art)
        saved = spawn_child(cache, "ckpt", "checkpoint", work)
        resumed = spawn_child(cache, "resume", "restore", work)
    walls = {"boots_s": round(time.perf_counter() - t0, 1)}
    check(saved["in_flight"] > 0, "persist: no request in flight at the "
          "checkpoint")
    for side in (saved, resumed):
        check(side["stats"]["traced_iterations"] == 0
              and side["stats"]["retraces"] == 0,
              f"persist: a checkpoint side traced: {side['stats']}")
    done = {int(k): v for k, v in saved["tokens"].items()}
    done.update({int(k): v for k, v in resumed["tokens"].items()})
    check([done[k] for k in sorted(done)] == cold["serve"]["tokens"],
          "persist: the restored scheduler's tokens differ from an "
          "uninterrupted run's")
    st = resumed["stats"]
    compiled = st["iterations"] - st["traced_iterations"]
    layers = get_config("llama3-8b").n_layers
    check(resumed["paged_launches"] == compiled * layers and compiled > 0,
          f"persist: paged launches after the restore "
          f"{resumed['paged_launches']} != {compiled} compiled steps x "
          f"{layers}")
    log("persist scheduler checkpoint: " + json.dumps({
        "in_flight": saved["in_flight"], "queued": saved["queued"],
        "bytes": saved["bytes"], "save_s": round(saved["save_s"], 3),
        "restore_s": round(resumed["restore_s"], 3),
        "paged_launches_after_restore": resumed["paged_launches"],
        "restores": st["checkpoint_restores"],
        "ckpt_side": saved["stats"], "resume_side": st}))

    # an engine checkpoint of one of the ten programs (its SGD assigns
    # Variables): the restored engine's losses equal the donor's own
    step, _ = programs.REGISTRY["gpt2"]("terra")
    tf = core.function(step)
    for i in range(8):
        float(tf(i))
    with tempfile.TemporaryDirectory(prefix="terra-ckpt-") as d:
        t0 = time.perf_counter()
        tf.save_checkpoint(d)
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(d)
        want = [float(tf(i)) for i in range(8, 16)]
        tf.close()
        tf = core.function(step)       # a fresh engine, the same Variables
        t0 = time.perf_counter()
        tf.restore_checkpoint(d)
        restore_s = time.perf_counter() - t0
    got = [float(tf(i)) for i in range(8, 16)]
    tf.close()
    rel = float(np.max(np.abs(np.asarray(got) - want) / np.abs(want)))
    check(rel <= 1e-6, f"persist: restored losses {got} != {want}")
    log("persist engine checkpoint (gpt2 program): " + json.dumps({
        "bytes": nbytes, "save_s": round(save_s, 4),
        "restore_s": round(restore_s, 4), "max_rel_diff": rel,
        "losses": got}))
    log(f"persist walls (s): {json.dumps(walls)}")
    release()

# --------------------------------------------------------------------------
# phase launch: mamba2-130m trained by the launcher (the SSD kernel's
# forward with the plain math's backward), and phase parallel
# --------------------------------------------------------------------------

LAUNCH_ARGS = ["--arch", "mamba2-130m", "--batch", "8", "--seq-len", "2048",
               "--log-every", "1", "--ckpt-every", "1000",
               "--total-steps", "30"]
LAUNCH_STEPS, LAUNCH_RESUME = 20, 10
# the f32 arms: 2 layers, fewer rows (a later --batch wins)
LAUNCH_PARITY = ["--layers", "2", "--dtype", "float32", "--batch", "2"]
LAUNCH_CPU = ["--arch", "mamba2-130m", "--layers", "2", "--dtype", "float32",
              "--batch", "1", "--seq-len", "512", "--log-every", "1"]
LAUNCH_CPU_STEPS = 8
LAUNCH_RTOL = 1e-3          # f32 losses of a resumed run vs an unbroken one
SSD_TRAIN = (8, 2048)       # the launcher's batch x tokens


def run_launcher(argv):
    """``repro_torch.launch.train.main(argv)`` in this process, its printed
    lines kept, the SSD-scan forward and backward launches counted from 0
    over the run, and on
    the card each step waited for (``_SyncedSteps``): the step times, the
    engine counters and the peak memory.  Returns a dict."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import train as LT

    base = LT.Trainer
    made = []

    class Timed(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if self.use_terra and self.device.type == "cuda":
                self._iteration = _SyncedSteps(self._iteration)
            made.append(self)

        def train(self, *a, **k):
            out = super().train(*a, **k)
            if self.use_terra:
                self.stats = dict(self._iteration.stats)
            return out

    cuda = "cpu" not in argv
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    LT.Trainer = Timed
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            LT.main(argv)
    finally:
        LT.Trainer = base
    wall = time.perf_counter() - t0
    counts = read_counts()
    tr = made[0]
    out = {"stdout": buf.getvalue(), "launches": counts["ssd_scan"],
           "bwd_launches": counts["ssd_scan_bwd"],
           "conv_launches": counts["causal_conv"],
           "conv_bwd_launches": counts["causal_conv_bwd"], "wall_s": wall,
           "history": tr.history, "start_step": tr.start_step,
           "stats": {k: v for k, v in getattr(tr, "stats", {}).items()
                     if isinstance(v, int)}}
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        it = tr._iteration
        out["step_ms"] = [t * 1e3 for t in getattr(it, "times", [])]
    del made, tr
    release()
    return out


def launch_child(argv_json) -> int:
    """A child process of phase launch: the launcher on the card, one JSON
    line of :func:`run_launcher`'s result last."""
    res = run_launcher(json.loads(argv_json))
    sys.stdout.write(res["stdout"])
    print(json.dumps({k: v for k, v in res.items() if k != "stdout"}),
          flush=True)
    return 0


def spawn_launch(argv, label):
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--launch-child", json.dumps(argv)], cwd=HERE,
                       capture_output=True, text=True, timeout=400)
    check(p.returncode == 0, f"launch {label} exited {p.returncode}:\n"
          f"{p.stderr[-4000:]}")
    lines = p.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    out["stdout"] = "\n".join(lines[:-1])
    out["proc_s"] = time.perf_counter() - t0
    return out


def _launch_losses(res):
    return [l for _, l in res["history"]]


def ssd_training_row(launches):
    """The SSD scan at the launcher's shape (x [8, 2048, 24, 64], N 128):
    ``SSDScan`` (the kernel forward, the gradient kernel's backward: one
    launch each) against all-plain autograd of ``ssd_chunked_plain`` on
    the card, f32 and bf16 — forward within SSD_TOL, every gradient within
    SSD_BWD_TOL of its largest value — then the forward kernel's time a
    call (CUDA events, three turns, the median) beside the plain
    forward's, and the bound.  No single PyTorch call computes the SSD
    scan."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import SSD_TOL
    from repro_torch.models.ssm import SSDScan, ssd_chunked_plain
    B, S = SSD_TRAIN
    err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        args = ssd_inputs(B, S, MAMBA_H, MAMBA_P, MAMBA_N, dtype, 200,
                          dtype, strided=False)
        w = seeded((B, S, MAMBA_H, MAMBA_P), torch.float32, 201)
        xs = [a.clone().requires_grad_(True) for a in args]
        n0, b0 = kops.ssd_scan.launches, kops.ssd_scan_bwd.launches
        y = SSDScan.apply(*xs, MAMBA_CHUNK, False)
        got = torch.autograd.grad((y.float() * w).sum(), xs)
        check(kops.ssd_scan.launches == n0 + 1
              and kops.ssd_scan_bwd.launches == b0 + 1,
              "SSDScan did not launch each kernel once")
        ps = [a.clone().requires_grad_(True) for a in args]
        yp = ssd_chunked_plain(*ps, MAMBA_CHUNK)
        want = torch.autograd.grad((yp.float() * w).sum(), ps)
        e, ok = close_err(y, yp, SSD_TOL[name])
        check(ok, f"SSDScan forward vs plain at the training shape {name}: "
              f"{e}")
        rel = max(float((g.float() - h.float()).abs().max()
                        / h.float().abs().max()) for g, h in zip(got, want))
        log(f"ssd_scan training [{B},{S},{MAMBA_H},{MAMBA_P}] N={MAMBA_N} "
            f"{name}: forward max_abs_err vs plain {e:.3e} (tol "
            f"{SSD_TOL[name]}); gradients (x, dt, A, B, C) of the kernel vs "
            f"all-plain autograd: max rel err {rel:.3e} (tol "
            f"{SSD_BWD_TOL[name]})")
        check(rel <= SSD_BWD_TOL[name],
              f"SSDScan gradients vs plain {name}: {rel}")
        if dtype == torch.bfloat16:
            err = e
        del args, xs, ps, y, yp, got, want
        release()
    ins = [ssd_inputs(B, S, MAMBA_H, MAMBA_P, MAMBA_N, torch.bfloat16,
                      210 + i, torch.bfloat16, strided=True)
           for i in range(2)]
    call = rotating([lambda t=t: kops.ssd_scan(*t, chunk=MAMBA_CHUNK)
                     for t in ins])
    # a call is ~0.5 ms of device work, far above its launch cost, so
    # back-to-back CUDA events time it (the profiler's device-time sum
    # lost most of the kernels' events in some turns); the profiler
    # gives the split over the three kernels
    runs = [time_ms(call, 20) for _ in range(3)]
    ms = sorted(runs)[1]
    dev, split = device_split(call, 20)
    plain_ms = time_ms(rotating([
        lambda t=t: ssd_chunked_plain(*t, MAMBA_CHUNK) for t in ins]), 4)
    bound, by = ssd_bound_ms(ins[0][0], ins[0][1], ins[0][3], False)
    log(f"ssd_scan bf16 training [{B},{S},{MAMBA_H},{MAMBA_P}] N={MAMBA_N}: "
        f"{ms:.5f} ms a call by CUDA events (turns "
        + ", ".join(f"{d:.5f}" for d in runs)
        + f"); profiler device time {dev:.5f} ms, per kernel "
        + "; ".join(f"{k} {v:.5f}" for k, v in split.items())
        + f"; {ms / bound:.1f}x the bound {bound:.5f} ms ({by}); plain "
        f"{plain_ms:.4f} ms; no PyTorch library call computes the SSD scan")
    del ins
    release()
    return {"name": f"ssd_scan[mamba2 training {B}x{S}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:21",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def phase_launch(rows):
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-130m")
    # each forward launches the kernel once a layer; remat ("full")
    # recomputes each super-block's forward in the backward
    per_step = cfg.n_layers * (2 if cfg.remat else 1)
    d = tempfile.mkdtemp(prefix="launch_")
    try:
        a = spawn_launch(LAUNCH_ARGS + ["--steps", str(LAUNCH_STEPS),
                                        "--ckpt-dir", d], "first")
        b = spawn_launch(LAUNCH_ARGS + ["--steps", str(LAUNCH_RESUME),
                                        "--ckpt-dir", d], "resume")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for label, res, steps in (("first", a, LAUNCH_STEPS),
                              ("resume", b, LAUNCH_RESUME)):
        out = res["stdout"]
        losses = _launch_losses(res)
        steady = res["step_ms"][res["stats"]["traced_iterations"]:]
        med = float(np.median(steady))
        if label == "first":
            LAUNCH_MEASURED.update(step_ms=med, peak_gib=res["peak_gib"])
        log(f"launch {label}: " + " | ".join(
            l for l in out.splitlines() if l.startswith(("launch:", "auto-",
                                                         "done:"))))
        log(f"launch {label}: mamba2-130m (24 layers, d 768, vocab 50280, "
            f"remat {cfg.remat}), 8 x 2048 tokens, steps "
            f"{res['history'][0][0]}..{res['history'][-1][0]}: median step "
            f"{med:.2f} ms over {len(steady)} co-executed steps (each "
            f"waited for; min {min(steady):.2f}, max {max(steady):.2f}), "
            f"first step {res['step_ms'][0]:.1f} ms, "
            f"{8 * 2048 / med * 1e3:.0f} tokens/s at the median, "
            f"max_memory_allocated {res['peak_gib']:.3f} GiB, ssd_scan "
            f"launches {res['launches']} ({res['launches'] / steps:.1f} a "
            f"step), ssd_scan_bwd launches {res['bwd_launches']} "
            f"({res['bwd_launches'] / steps:.1f} a step), causal_conv "
            f"launches {res['conv_launches']} / {res['conv_bwd_launches']} "
            f"(forward / gradient), process "
            f"{res['proc_s']:.1f} s, launcher {res['wall_s']:.1f} s")
        log(f"launch {label} losses: "
            + json.dumps([round(l, 5) for l in losses]))
        log(f"launch {label} counters: " + json.dumps(res["stats"]))
        check("devices=1 mesh=1-device" in out and "done: loss" in out
              and "terra: {" in out, f"launch {label}: launcher lines "
              f"missing:\n{out[-2000:]}")
        check(all(np.isfinite(losses)) and len(losses) == steps,
              f"launch {label}: losses {losses}")
        check(res["launches"] == per_step * steps,
              f"launch {label}: {res['launches']} ssd_scan launches, not "
              f"{per_step} x {steps}")
        check(res["bwd_launches"] == cfg.n_layers * steps,
              f"launch {label}: {res['bwd_launches']} ssd_scan_bwd "
              f"launches, not {cfg.n_layers} x {steps}")
        # the conv runs beside the scan in every layer's forward and
        # gradient
        check(res["conv_launches"] == per_step * steps
              and res["conv_bwd_launches"] == cfg.n_layers * steps,
              f"launch {label}: causal_conv launches "
              f"{res['conv_launches']} / {res['conv_bwd_launches']}, not "
              f"{per_step} / {cfg.n_layers} x {steps}")
    check(_launch_losses(a)[-1] < _launch_losses(a)[0],
          "launch: the loss did not fall")
    check(f"auto-resumed from step {LAUNCH_STEPS}" in b["stdout"]
          and b["start_step"] == LAUNCH_STEPS
          and b["history"][0][0] == LAUNCH_STEPS + 1,
          "launch: the second process did not resume")
    rows.append(ssd_training_row(a["launches"]))
    for row in rows:
        if row["name"] == SSD_BWD_NAME:
            row["launches"] = a["bwd_launches"]
        if row["name"] in CONV_NAMES:
            row["launches"] = a["conv_launches" if row["name"] ==
                                CONV_NAMES[0] else "conv_bwd_launches"]

    # 2 layers in f32 (TF32 off): steps 21-30 of a resumed run against an
    # unbroken one, then card against CPU
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d1, d2 = tempfile.mkdtemp(prefix="launch_"), tempfile.mkdtemp(
        prefix="launch_")
    try:
        base = LAUNCH_ARGS + LAUNCH_PARITY
        run_launcher(base + ["--steps", str(LAUNCH_STEPS), "--ckpt-dir", d1])
        resumed = run_launcher(base + ["--steps", str(LAUNCH_RESUME),
                                       "--ckpt-dir", d1])
        whole = run_launcher(base + ["--steps", str(LAUNCH_STEPS
                                                    + LAUNCH_RESUME)])
        got = _launch_losses(resumed)
        want = _launch_losses(whole)[LAUNCH_STEPS:]
        rel = float(np.max(np.abs(np.asarray(got) - want) / np.abs(want)))
        log(f"launch resume parity (2 layers, f32, 2 x 2048; "
            f"{resumed['wall_s']:.1f} s resumed, {whole['wall_s']:.1f} s "
            f"unbroken): steps 21-30 resumed "
            f"{json.dumps([round(l, 6) for l in got])} vs unbroken "
            f"{json.dumps([round(l, 6) for l in want])}: max rel err "
            f"{rel:.3e} (rtol {LAUNCH_RTOL})")
        check(rel <= LAUNCH_RTOL, f"launch resume parity: {rel}")

        # every arm resumes one step-0 checkpoint the CPU launcher wrote
        run_launcher(LAUNCH_CPU + ["--steps", "0", "--device", "cpu",
                                   "--ckpt-dir", d2])
        arms = {}
        for name, dev in (("card", []), ("cpu", ["--device", "cpu"])):
            d3 = tempfile.mkdtemp(prefix="launch_")
            try:
                shutil.copytree(d2, d3, dirs_exist_ok=True)
                res = run_launcher(LAUNCH_CPU + dev + [
                    "--steps", str(LAUNCH_CPU_STEPS), "--ckpt-dir", d3])
            finally:
                shutil.rmtree(d3, ignore_errors=True)
            arms[name] = _launch_losses(res)
            if name == "card":
                check(res["launches"] == per_step // cfg.n_layers
                      * 2 * LAUNCH_CPU_STEPS
                      and res["bwd_launches"] == 2 * LAUNCH_CPU_STEPS,
                      f"launch card arm: {res['launches']} ssd_scan and "
                      f"{res['bwd_launches']} ssd_scan_bwd launches (2 "
                      f"layers)")
            log(f"launch parity arm {name} (2 layers, f32, 1 x 512): "
                f"losses {json.dumps([round(l, 6) for l in arms[name]])} "
                f"({res['wall_s']:.1f} s)")
        rel = float(np.max(np.abs(np.asarray(arms["card"]) - arms["cpu"])
                           / np.abs(arms["cpu"])))
        log(f"launch parity card (kernel forward and backward) vs cpu "
            f"(plain): max rel "
            f"err {rel:.3e} (rtol {PARITY_RTOL})")
        check(rel <= PARITY_RTOL, f"launch parity card vs cpu: {rel}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
        for p in (d1, d2):
            shutil.rmtree(p, ignore_errors=True)
    release()


PARALLEL_MOE = (4, 512)          # deepseek-moe-16b tokens: batch x length


def phase_parallel():
    """The parallel layer on one card: a one-process NCCL group.  The
    compressed data-parallel all-reduce (bf16) on CUDA tensors —
    with one rank the mean is the codec's round trip, so mean + residual
    must give the gradient back — and deepseek-moe-16b at published width
    (2 of 28 layers, bf16) with ``moe_impl="shard_map"`` on a (1, 1)
    (data, model) mesh against the ``moe_block`` path."""
    import dataclasses as dc
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import model as M
    from repro_torch.parallel.compression import (dp_allreduce,
                                                  wire_bytes_saved,
                                                  zero_residuals)
    from repro_torch.parallel.sharding import ShardingPolicy, use_policy

    tmp = tempfile.mkdtemp(prefix="nccl_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh_for({"data": 1})
        g = {"w": seeded((4096, 1024), torch.float32, 300),
             "b": seeded((1000,), torch.float32, 301)}
        for c, tol in (("bf16", 2 ** -8),):
            red = dp_allreduce(mesh, "data", compression=c)
            mean, resid = red(g, zero_residuals(g))
            ms = time_ms(lambda: red(g, zero_residuals(g)), 10)
            for k in g:
                check(mean[k].is_cuda and mean[k].dtype == torch.float32,
                      f"dp_allreduce {c}: {mean[k].device} {mean[k].dtype}")
                back = float((mean[k] + resid[k] - g[k]).abs().max())
                err = float((mean[k] - g[k]).abs().max()
                            / g[k].abs().max())
                check(back <= 1e-6 and err <= tol,
                      f"dp_allreduce {c} {k}: mean+resid-g {back}, "
                      f"rel err {err}")
            raw, wire = wire_bytes_saved(g, c)
            log(f"parallel dp_allreduce {c} (NCCL, 1 rank, CUDA tensors "
                f"{[tuple(v.shape) for v in g.values()]}): mean within "
                f"{tol:.3g} of the gradient, mean + residual == gradient, "
                f"{ms:.3f} ms a call; wire bytes {raw} -> {wire}")

        cfg = dc.replace(get_config("deepseek-moe-16b"), n_layers=2)
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        B, S = PARALLEL_MOE
        tokens = torch.from_numpy(np.random.RandomState(7).randint(
            0, cfg.vocab, (B, S)).astype(np.int32)).cuda()
        mesh2 = make_mesh_for({"data": 1, "model": 1})
        with use_policy(ShardingPolicy(mesh2)), torch.no_grad():
            ref = M.forward(cfg, params, tokens)
            got = M.forward(dc.replace(cfg, moe_impl="shard_map"), params,
                            tokens)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        log(f"parallel moe shard_map vs moe_block: deepseek-moe-16b (2 of "
            f"28 layers, d 2048, 64 experts top-6 + 2 shared, bf16), "
            f"{B} x {S} tokens, (1, 1) mesh: max abs err {err:.3e} "
            f"(logits up to {scale:.3f}; exactly equal: {err == 0.0})")
        check(bool(torch.isfinite(got.float()).all())
              and err <= 1e-2 * scale, f"moe shard_map vs moe_block: {err}")
        del params, ref, got
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    release()


# phase launch's measured median step (ms) and peak (GiB), for phase dryrun
LAUNCH_MEASURED = {}
DRYRUN_CELLS = (("llama3-8b", "decode_32k"), ("mamba2-130m", "train_4k"),
                ("mamba2-130m", "decode_32k"))


def dryrun_terms(rec) -> str:
    from repro_torch.launch import dryrun as D
    r, mem = rec["roofline"], rec["memory"]
    return (f"compute {r['compute_s'] * 1e3:.4f} ms, memory "
            f"{r['memory_s'] * 1e3:.4f} ms, collective "
            f"{r['collective_s'] * 1e3:.4f} ms "
            f"({r['per_coll']['n_collectives']:.0f} collectives), dominant "
            f"{r['dominant']}, FLOPs {r['flops']:.4e} (model "
            f"{r['model_flops_per_device']:.4e}), peak "
            f"{mem['total_nonalias_bytes'] / 2 ** 30:.3f} GiB a card "
            f"(fits {rec['fits_hbm']}), {D.n_resharded(rec)} ops re-run "
            f"by the counter on a replicated input")


def phase_dryrun():
    """The analytic dry run in this process: two production cells, then
    phase launch's own shape beside its measurement.  The dry run's
    numbers are analytic (the H100 data sheet's rates), not measured."""
    import torch
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.launch import dryrun as D

    before = torch.cuda.memory_allocated()
    zero_counts()
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = D.run_cell(arch, shape, "single", verbose=False)
        check(rec["status"] == "ok",
              f"dryrun {arch} x {shape}: {rec.get('error')}")
        log(f"dryrun {arch} x {shape} x single ({rec['n_chips']} cards, "
            f"analytic): {dryrun_terms(rec)}; "
            f"{time.perf_counter() - t0:.1f} s")
    name = "launch_8x2048"
    SHAPES[name] = ShapeConfig(name, "train", 2048, 8)
    try:
        t0 = time.perf_counter()
        rec = D.run_cell("mamba2-130m", name, "single", verbose=False,
                         opts={"mesh_shape": (1, 1), "microbatches": 1})
    finally:
        del SHAPES[name]
    check(rec["status"] == "ok", f"dryrun at the launch shape: "
          f"{rec.get('error')}")
    measured = ("median step {step_ms:.2f} ms, max_memory_allocated "
                "{peak_gib:.3f} GiB".format(**LAUNCH_MEASURED)
                if LAUNCH_MEASURED else "not measured in this run")
    log(f"dryrun mamba2-130m at phase launch's shape (1 x 1 mesh, 8 x "
        f"2048, remat full; analytic): {dryrun_terms(rec)}; "
        f"{time.perf_counter() - t0:.1f} s.  Measured by phase launch: "
        f"{measured}")
    after = torch.cuda.memory_allocated()
    check(after == before, f"dryrun: memory_allocated moved {before} -> "
          f"{after}")
    counts = read_counts()
    log(f"dryrun kernel launches: {json.dumps(counts)} (meta tensors "
        f"launch none)")
    check(not any(counts.values()), f"dryrun launched kernels: {counts}")
    import torch.distributed as dist
    check(not dist.is_initialized(), "dryrun: a process group was left")


EXAMPLE_RUNS = (
    ("serve_continuous_torch", ["--arch", "llama3-8b", "--requests", "4",
                                "--max-slots", "2", "--max-len", "64",
                                "--mean-gap-ms", "1"]),
    ("quickstart_torch", []),
    ("coexec_showcase_torch", []),
)


def run_example(name, argv) -> str:
    """``examples/<name>.py``'s main(argv), freshly loaded: its output."""
    import contextlib
    import importlib
    import io
    mod = importlib.import_module(f"examples.{name}")
    mod = importlib.reload(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


def example_lines(out):
    """(losses, phases, int stats) of a quickstart/coexec output."""
    import ast
    losses = [float(m) for m in re.findall(r"loss[= ]\s*(-?[0-9.]+)", out)]
    phases = re.findall(r"phase=(\S+)", out)
    line = [ln for ln in out.splitlines() if ln.startswith("stats:")][-1]
    return losses, phases, ast.literal_eval(line[len("stats:"):].strip())


def phase_examples():
    """The three examples' main() on the card (quickstart and
    coexec_showcase also on the CPU, to hold the card's lines to)."""
    import numpy as np
    zero_counts()
    for name, argv in EXAMPLE_RUNS:
        t0 = time.perf_counter()
        out = run_example(name, argv)
        wall = time.perf_counter() - t0
        log(f"examples {name} (card, {wall:.1f} s): "
            + " | ".join(out.strip().splitlines()[-3:]))
        if name.startswith("serve_continuous"):
            check("retired=4" in out and "phase=co-execution" in out
                  and "retraces=0" in out, f"examples {name}:\n{out}")
            continue
        cpu = run_example(name, argv + ["--device", "cpu"])
        (lc, pc, sc), (lh, ph, sh) = example_lines(out), example_lines(cpu)
        n = 8 if name.startswith("coexec") else len(lh)
        err = float(np.max(np.abs(np.asarray(lc[:n]) - lh[:n])))
        log(f"examples {name}: losses card vs CPU max abs err {err:.2e} "
            f"over {n} printed; phases {pc[-1]}; stats equal "
            f"{sc == sh}: {json.dumps(sc)}")
        check(len(lc) == len(lh) and all(np.isfinite(lc)) and err <= 1e-3
              and pc == ph and sc == sh and "co-execution" in pc,
              f"examples {name}: card\n{out}\nCPU\n{cpu}")
    counts = read_counts()
    log(f"examples kernel launches: {json.dumps(counts)} (the scheduler's "
        f"default pipeline is \"safe\"; the other two hold no rms_norm "
        f"or attention chain)")
    check(not any(counts.values()), f"examples launched kernels: {counts}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after the build "
                         "(a partial run: no result lines, for bring-up)")
    ap.add_argument("--persist-child", nargs=2, default=None,
                    metavar=("ROLE", "DIR"), help=argparse.SUPPRESS)
    ap.add_argument("--launch-child", default=None, metavar="ARGV",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()

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
    if args.persist_child:          # a child process of phase persist
        try:
            return persist_child(*args.persist_child)
        except SmokeFailure as e:
            print(f"chip_smoke: persist child: FAIL: {e}", file=sys.stderr)
            return 1
    if args.launch_child:           # a child process of phase launch
        return launch_child(args.launch_child)

    try:
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        built = build.build_all(["paged_attention", "rmsnorm",
                                 "flash_attention", "ssd_scan",
                                 "causal_conv"])
        log(f"build: {json.dumps(built)} (wall {time.perf_counter() - t0:.1f}"
            f" s)")
        for name, text in build.LOGS.items():
            entries = ptxas_entries(text)
            log(f"  ptxas[{name}]: {len(entries)} kernels, at most "
                f"{max((e[1] for e in entries), default=0)} registers, at "
                f"most {max((e[2] for e in entries), default=0)} bytes "
                f"spill stores")
            for kname, regs, spill in entries:
                # every rmsnorm, SSD and flash kernel (whisper's D 64
                # too); paged at the path widths (D 128 and 256) and the
                # registry's groups
                if name in ("rmsnorm", "ssd_scan", "flash_attention",
                            "causal_conv") \
                        or re.search(r"[<,](128|256)[,>]", kname) \
                        or not re.search(r"[<,]\d", kname):
                    log(f"    {kname}: {regs} registers, {spill} bytes "
                        f"spill stores")
        smi = nvidia_smi_line()
        log(f"card: {smi}")
        rows = []

        def kernel_rows():
            rows.extend([phase_kernels(),
                         rmsnorm_kernel_row((SCORE_BATCH, SCORE_SEQ, 4096)),
                         flash_kernel_row(SCORE_BATCH * 32, SCORE_SEQ),
                         ssd_kernel_row(), ssd_bwd_kernel_row()])
            rows.extend(family_paged_rows() + [flash_d256_row()]
                        + flash_whisper_rows())

        phases = [
            ("kernels", kernel_rows),
            ("conv", lambda: phase_conv(rows)),
            ("serving", lambda: phase_serving(rows)),
            ("tokens", phase_tokens),
            ("coexec-kernels", lambda: phase_coexec_kernels(rows)),
            ("coexec-equality", phase_coexec_equality),
            ("mamba2-serving", lambda: phase_mamba2_serving(rows)),
            ("mamba2-equality", phase_mamba2_equality),
            ("programs", phase_programs),
            ("train", phase_train),
            ("capture", phase_capture),
            ("families", lambda: phase_families(rows)),
            ("cross", lambda: phase_cross(rows)),
            ("obs", lambda: phase_obs(os.path.join(HERE, "chiprun_out"))),
            ("persist", phase_persist),
            ("launch", lambda: phase_launch(rows)),
            ("parallel", phase_parallel),
            ("dryrun", phase_dryrun),
            ("examples", phase_examples),
        ]
        if args.only:
            names = args.only.split(",")
            check(set(names) <= {n for n, _ in phases},
                  f"--only: unknown phases {names}")
            phases = [(n, r) for n, r in phases if n in names]
        walls = {}
        for name, run in phases:
            t0 = time.perf_counter()
            run()
            walls[name] = round(time.perf_counter() - t0, 1)
            log(f"phase {name}: {walls[name]} s")
        log(f"phase walls: {json.dumps(walls)}")
        if args.only:
            log("chip_smoke: partial run (--only), no result")
            return 0
        # a row's launches are its own shape's on a main path of this
        # run, zeroed just before it; a row in OFF_PATH says 0 and why
        for row in rows:
            if row["launches"] is None and row["name"] in OFF_PATH:
                row["launches"] = 0
                log(f"{row['name']}: 0 launches, {OFF_PATH[row['name']]}")
        check(all(r["launches"] for r in rows if r["name"] not in OFF_PATH),
              "a kernel row has no launches on its main path")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    log(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
