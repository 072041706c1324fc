"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration is
``configs/<config>.json``, the mix ``traffic/<traffic>.json`` (its
``driver`` key names the general driver, ``drivers/<driver>.py``, that
reads it), the cell's correctness limits ``limits/<cell>.json``, and each
per-layer metric is read by ``metrics/<metric>.py``.  Adding a cell, a
configuration, a mix or a metric adds files and manifest entries; no file
here changes."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re
from typing import List, Optional

from portbench.core.env import ROOT

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: everywhere without a
    ``workloads`` key, else in the cells it lists."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<cell>.json
    end_to_end: List[dict]  # the manifest's metrics this cell reports
    per_layer: List[dict]
    chips: int


def cell(name: str, man: Optional[dict] = None, base: str = HERE,
         traffic_dir: Optional[str] = None) -> Cell:
    """The cell ``name`` with every file it names loaded.  ``traffic_dir``
    looks for the mix there first (a test's throwaway mix)."""
    man = man if man is not None else manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    config = load_json(os.path.join(base, "configs", w["config"] + ".json"))
    mix = None
    for d in ([traffic_dir] if traffic_dir else []) + [
            os.path.join(base, "traffic")]:
        path = os.path.join(d, w["traffic"] + ".json")
        if os.path.exists(path):
            mix = load_json(path)
            break
    if mix is None:
        raise FileNotFoundError(f"no traffic mix {w['traffic']!r}")
    limits_path = os.path.join(base, "limits", name + ".json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    return Cell(name=name, config=config, traffic=mix, limits=limits,
                end_to_end=[m for m in man["end_to_end"] if applies(m, name)],
                per_layer=[m for m in man["per_layer"] if applies(m, name)],
                chips=int(w.get("chips", 1)))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """``drivers/<kind>.py``: the general driver a mix names."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(metric: str, base: str = HERE):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(base, "metrics", metric + ".py")
    return load_module(path, "portbench_metric_" +
                       re.sub(r"\W", "_", metric)).read


def reference(name: str):
    """``reference/<name>.py``: the plain reference a configuration names."""
    return importlib.import_module(f"portbench.reference.{name}")


def check_names(man: dict) -> List[str]:
    """Every name, unit and key of the manifest that breaks the rules for
    their characters; empty when all are fine."""
    bad = []
    names = [c["name"] for c in man["configs"]]
    names += [w["name"] for w in man["workloads"]]
    names += [w["config"] for w in man["workloads"]]
    names += [w["traffic"] for w in man["workloads"]]
    names += [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    bad += [n for n in names if not NAME.match(n)]
    bad += [m["unit"] for m in man["end_to_end"] + man["per_layer"]
            if not UNIT.match(m["unit"])]
    bad += [m["name"] for m in man["end_to_end"] + man["per_layer"]
            if m["better"] not in ("lower", "higher")]
    return bad

