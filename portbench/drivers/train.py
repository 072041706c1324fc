"""The training driver: the port's ``Trainer`` driven step after step
through its co-executed iteration (``Trainer._iteration``, the call
``Trainer.train`` makes), fed by batches made from the seed.

Set-up builds one trainer on the benchmark's weights, runs its first
``setup_steps`` steps through that same call, and hands the same trainer
to the window.  Terra traces the first step, warms the captured segment
up on the second and captures it on the third; the last three steps of
set-up are replays of the captured step, as every step of the window is,
and they are what the reference is held to: the loss of every set-up
step, each leaf's gradient on the middle one of the three (the
optimizer's first moment after it, less beta1 times the moment before
it), and each leaf's change over the three (the masters before and
after them).  The window dispatches steps as ``Trainer.train`` does, with
no sync but the loss fetched every ``log_every`` steps, until ``seconds``
have passed; it ends at the synchronise after the last step.  Once it has
closed and the trainer is freed, the plain reference runs all the set-up
steps from the same weights and batches.

Mix keys: ``batch``, ``seq_len``, ``opt`` (AdamW), ``z_loss``,
``setup_steps`` (at least 6, so that the compared steps are replays),
``log_every``, ``use_terra``, ``traced_kernels`` (the kernels whose
profiled counts must equal their launch counters)."""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import numpy as np

from portbench.core import devtrace, manifest
from portbench.core import weights as W
from portbench.core.runner import Outcome
from portbench.roofline import kernels as KN

STEADY = 3      # the set-up's last steps, compared with the reference


def batch_at(seed: int, i: int, B: int, S: int, V: int):
    """Step ``i``'s batch: tokens uniform over the vocabulary, labels the
    next token; every row its own draw."""
    rng = np.random.default_rng([int(seed), int(i)])
    t = rng.integers(0, V, size=(B, S + 1), dtype=np.int32)
    return t[:, :-1].copy(), t[:, 1:].copy()


def counters(trainer) -> dict:
    from repro_torch.kernels import ops as kops
    eng = trainer._iteration.engine
    out = {k: v for k, v in trainer._iteration.stats.items()
           if isinstance(v, (int, float)) and not isinstance(v, bool)}
    cap = eng.capture.stats if eng.capture is not None else {}
    out.update({"capture." + k: v for k, v in cap.items()})
    out.update({"launch." + k: getattr(kops, k).launches
                for k in KN.WRAPPERS})
    return out


def gap_rel(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of a run (``prog``: its step losses, each
    leaf's gradient norm on the compared step and its change norm over the
    compared steps) against the reference's: the largest relative gap of
    a step's loss, and the worst leaf's gap of each norm.  The change
    leaves out leaves whose reference gradient is under a thousandth of
    the median leaf's (they move by round-off alone under Adam)."""
    med = statistics.median(ref["grad"].values())
    moved = {k for k, g in ref["grad"].items() if g >= 1e-3 * med}
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(prog["loss"], ref["loss"])),
            "grad_gap": gap_rel(prog["grad"], ref["grad"]),
            "change_gap": gap_rel(prog["change"], ref["change"], moved)}


def steps(tr) -> tuple:
    """(the first compared step, the step whose gradient is compared),
    counted from 0."""
    first = tr["setup_steps"] - STEADY
    return first, first + 1


def set_up(cell, seed: int, dev: str):
    """One trainer on the benchmark's weights, driven through its set-up
    steps: (trainer, the weights as made, the program's readings)."""
    import torch
    from repro_torch.core.pytree import tree_unflatten
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    tr = cell.traffic
    cfg = W.model_config(cell.config)
    B, S, V = tr["batch"], tr["seq_len"], cfg.vocab
    b1 = tr["opt"]["beta1"]
    _, w0 = W.make_params(cfg, seed, dev)
    trainer = Trainer(cfg, OptConfig(**tr["opt"]), ckpt_dir=None, batch=B,
                      seq_len=S, use_terra=tr["use_terra"], device=dev)
    o_paths = W.leaf_paths(tree_unflatten(trainer._o_def,
                                          list(range(len(trainer.o_vars)))))
    master_vars = [trainer.o_vars[i] for path, i in o_paths
                   if path.startswith("master.")]
    with torch.no_grad():
        for (path, w), pv, mv in zip(w0, trainer.p_vars, master_vars):
            pv._value.copy_(w)
            mv._value.copy_(w.float())
    if not len(trainer.p_vars) == len(w0) == len(master_vars):
        raise RuntimeError("the trainer's state does not hold the model's "
                           "leaves")
    it = trainer._iteration

    def host(part):
        """A part of the optimizer's state as the program holds it after
        the step just dispatched, copied to the host in float64."""
        it.wait()
        return {p: t.detach().to("cpu", torch.float64) for p, t in
                W.leaf_paths(trainer.state_tree()["opt"][part])}

    first, g_at = steps(tr)
    if first < 0:
        raise ValueError("setup_steps must hold the compared steps")
    losses, m_prev, grad, m_from, change = [], None, None, None, None
    for i in range(tr["setup_steps"]):
        if i == first:
            m_from = host("master")
        loss, _ = it(*batch_at(seed, i, B, S, V))
        losses.append(float(loss))
        if i == g_at - 1:
            m_prev = host("m")
        if i == g_at:
            grad = {p: float(((t - b1 * m_prev[p]) / (1 - b1)).norm())
                    for p, t in host("m").items()}
            del m_prev
    change = {p: float((t - m_from[p]).norm())
              for p, t in host("master").items()}
    del m_from
    if dev == "cuda":
        torch.cuda.synchronize()
    return trainer, w0, {"loss": losses, "grad": grad, "change": change}


def free() -> None:
    """Return what the dropped objects held to the card."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(cell, w0, seed: int, dev: str, prec: str = "f32",
              rows: slice = slice(None)) -> dict:
    """The plain reference over every set-up step, from the same weights
    and batches (``rows``: the rows of each batch it takes)."""
    import torch
    tr = cell.traffic
    B, S, V = tr["batch"], tr["seq_len"], W.model_config(cell.config).vocab
    first, g_at = steps(tr)
    batches = [tuple(torch.from_numpy(a[rows]).to(dev)
                     for a in batch_at(seed, i, B, S, V))
               for i in range(tr["setup_steps"])]
    return manifest.reference(cell.config["reference"]).train(
        dict(w0), cell.config, batches, tr["opt"], tr["z_loss"], prec,
        grad_step=g_at, change_from=first)


def run(spec) -> Outcome:
    import torch

    tr, dev = spec.cell.traffic, spec.device
    B, S = tr["batch"], tr["seq_len"]
    V = W.model_config(spec.cell.config).vocab
    tracer = devtrace.Tracer(spec.trace)

    # ---- set-up: one trainer, driven through its set-up steps -------------
    trainer, w0, prog = set_up(spec.cell, spec.seed, dev)
    it = trainer._iteration

    def step(i):
        return it(*batch_at(spec.seed, i, B, S, V))

    # ---- the window ---------------------------------------------------------
    before = counters(trainer)
    losses, n = [], 0
    i0 = tr["setup_steps"]
    with tracer:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < spec.seconds:
            with tracer.span("iteration"):
                loss, _ = step(i0 + n)
            losses.append(loss)
            n += 1
            if n % tr["log_every"] == 0:
                with tracer.span("loss_fetch"):
                    float(loss)
        with tracer.span("drain"):
            it.wait()
            if dev == "cuda":
                torch.cuda.synchronize()
        t_end = time.perf_counter()
    after = counters(trainer)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    delta = {k: after[k] - before.get(k, 0) for k in after}
    failed = sum(1 for x in losses if not math.isfinite(float(x)))
    grown = {k: delta[k] for k in KN.COMPILE_COUNTERS if delta.get(k)}

    ctx = {"kind": "train", "config": spec.cell.config, "traffic": tr,
           "window_s": t_end - t_start, "steps": n, "tokens": n * B * S,
           "delta": delta, "traced": delta, "trace": tracer.trace,
           "compiled_in_window": grown}
    if tracer.trace is not None:
        KN.check_counts(tracer.trace, delta, tr.get("traced_kernels", ()))

    # ---- the reference, once the trainer is gone ----------------------------
    it.close()
    del it, trainer, losses, loss
    free()
    r = reference(spec.cell, w0, spec.seed, dev)
    for k in r["grad"]:
        print(f"leaf {k} grad {prog['grad'][k]!r} ref {r['grad'][k]!r} "
              f"change {prog['change'][k]!r} ref {r['change'][k]!r}",
              file=sys.stderr)
    print(f"loss {prog['loss']!r} ref {r['loss']!r}", file=sys.stderr)
    lim = spec.cell.limits
    got = numbers(prog, r)
    checks = [(k, got[k], v) for k, v in lim.items()]
    return Outcome(
        attempted=n, failed=failed,
        end_to_end={"train_tokens_per_s": n * B * S / (t_end - t_start),
                    "setup_s": t_start - spec.t0},
        checks=checks, memory_peak_bytes=peak, ctx=ctx,
        trace=tracer.trace)


def control(cell, seed: int, device: str,
            parts=("program", "fp8", "half_batch")) -> dict:
    """Readings at the cell's size, each against the float32 reference:
    ``program``, the program's set-up as a run drives it (its lower
    reading); ``fp8``, the reference computed in fp8 put in the program's
    place (the control); ``half_batch``, the fault of a step that takes
    half of its batch (the mean over the other half).  A step that leaves
    its state unchanged reads 1 on the change by construction and needs
    no run."""
    tr = cell.traffic
    out = {}
    if "program" in parts:
        trainer, w0, prog = set_up(cell, seed, device)
        trainer._iteration.close()
        del trainer
        free()
    else:
        _, w0 = W.make_params(W.model_config(cell.config), seed, device)
    f = reference(cell, w0, seed, device)
    if "program" in parts:
        out["program"] = numbers(prog, f)
        out["leaves"] = {k: [f["grad"][k], prog["grad"][k], f["change"][k],
                             prog["change"][k]] for k in f["grad"]}
        out["loss"] = [f["loss"], prog["loss"]]
    if "fp8" in parts:
        out["fp8"] = numbers(reference(cell, w0, seed, device, "fp8"), f)
    if "half_batch" in parts:
        out["half_batch"] = numbers(reference(
            cell, w0, seed, device, rows=slice(0, tr["batch"] // 2)), f)
    return out
