"""BENCHMARK.json against the contract's rules for names, keys and
metrics, and the files it names."""

import json
import os

from portbench.core import env, manifest

MAN = manifest.manifest()
BASE = os.path.join(env.ROOT, "portbench")


def test_names_and_units_use_the_allowed_characters():
    assert manifest.check_names(MAN) == []
    for bad in ("a b", "a,b", "a/b", "µs", ""):
        assert not manifest.NAME.match(bad)
    assert manifest.UNIT.match("tokens/s") and manifest.UNIT.match("%")
    assert not manifest.UNIT.match("tokens per second")


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert MAN["command"][1] == "portbench/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in MAN["end_to_end"])


def test_every_name_is_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in MAN[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_finds_its_files_and_reports_what_it_must():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        cell = manifest.cell(w["name"])
        assert w["chips"] in (1, 4)
        assert cell.config["name"] == w["config"]
        assert cell.limits, f"{w['name']} has no limits"
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            # each per-layer metric moves one end-to-end metric that every
            # cell reporting it also reports
            assert m["moves"] in e2e
            assert manifest.applies(e2e[m["moves"]], w["name"])
            assert callable(manifest.reader(m["name"]))
        manifest.driver(cell.traffic["driver"])
        manifest.reference(cell.config["reference"])


def test_configs_name_their_files_and_cuts():
    for c in MAN["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = manifest.load_json(os.path.join(env.ROOT, c["file"]))
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank"))
            # a key of the published configuration that the file changes
            assert k in cfg["published"] and cfg[k] != cfg["published"][k]
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_per_layer_layers_and_kernel_shares():
    for m in MAN["per_layer"]:
        assert m["layer"] and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_files_under_paths_are_named_from_name_characters():
    for d, _, files in os.walk(BASE):
        if "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), env.ROOT)
            assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel
