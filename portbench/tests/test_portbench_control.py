"""The correctness control at a size a test run holds: the plain
reference computed in fp8, put in the program's place, fails one of the
cell's numbers against the float32 reference (the card reads it at the
cell's own size with ``control.py``)."""

from portbench.drivers import train
from portbench.tests import smoke


def test_fp8_training_step_fails_a_number():
    cell = smoke.train_cell()
    got = train.control(cell, 5, "cpu", ("fp8", "half_batch"))
    lim = cell.limits
    assert any(v > lim[k] for k, v in got["fp8"].items()), got["fp8"]
    assert any(v > lim[k] for k, v in got["half_batch"].items())


def test_data_driven_mix_from_a_throwaway_directory(tmp_path):
    import json
    from portbench.core import manifest
    man = manifest.manifest()
    mix = dict(manifest.load_json(
        manifest.os.path.join(manifest.HERE, "traffic", "chat.json")))
    mix["output"] = {"dist": "fixed", "value": 5}
    (tmp_path / "throwaway-mix.json").write_text(json.dumps(mix))
    man = dict(man, workloads=man["workloads"] + [
        {"name": "deepseek-moe-16b.chat", "config": "deepseek-moe-16b",
         "traffic": "throwaway-mix", "chips": 1, "why": "test"}][-1:])
    cell = smoke.serve_cell(man=man, traffic_dir=str(tmp_path))
    assert cell.traffic["output"]["dist"] == "fixed"
    spec, out = smoke.run(cell)
    assert out.attempted > 0 and out.failed == 0
    assert out.end_to_end["ttft_p50_ms"] > 0
