"""One run of one cell: the workload driver's work, the per-layer readers, the
import guard and the result line.

A driver (``drivers/<name>.py``) has ``run(spec) -> Outcome``: it makes
the inputs from the seed, warms up, measures for ``spec.seconds`` (under
the profiler when ``spec.trace``), judges what the timed path produced,
and fills an :class:`Outcome`.  The per-layer metrics are read here from
``outcome.ctx`` by ``metrics/<name>.py``."""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from portbench.core import env, manifest


@dataclasses.dataclass
class Spec:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = 0.0                 # process start, on perf_counter
    fault: Optional[str] = None     # a test's planted fault (None: none)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]                    # name -> value
    checks: List[Tuple[str, float, float]]          # (name, value, limit)
    memory_peak_bytes: int
    ctx: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Any = None                               # devtrace.Trace

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for _, v, lim in self.checks)


def device_info(device: str, chips: int, peak: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def per_layer(spec: Spec, out: Outcome) -> Dict[str, float]:
    """Each of the cell's per-layer metrics its reader finds something to
    read for; a reader that finds nothing returns None and the metric is
    left out."""
    vals = {}
    for m in spec.cell.per_layer:
        v = manifest.reader(m["name"])(out.ctx)
        if v is not None:
            vals[m["name"]] = float(v)
    return vals


def result(spec: Spec, out: Outcome) -> dict:
    units = {m["name"]: m["unit"]
             for m in spec.cell.end_to_end + spec.cell.per_layer}
    vals = per_layer(spec, out) if spec.trace else {
        m["name"]: out.end_to_end[m["name"]] for m in spec.cell.end_to_end}
    dev = device_info(spec.device, spec.cell.chips, out.memory_peak_bytes)
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed),
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in vals.items()},
            "device": dev}
    if spec.trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in out.checks}
    return line


def finish(spec: Spec, out: Outcome) -> int:
    """Print the result line (or, where the JAX package or JAX was
    loaded, name what was and print none).  Returns the exit code."""
    bad = env.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    grown = out.ctx.get("compiled_in_window")
    if grown:
        print(f"portbench: traced or compiled inside the window: {grown}",
              file=sys.stderr)
    line = result(spec, out)
    print(json.dumps(line))
    for n, v, lim in out.checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    return 0
