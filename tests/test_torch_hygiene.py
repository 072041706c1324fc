"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points never pick the CPU on their own."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
IMPORT_RE = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)")


def _port_files():
    out = []
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    examples = sorted(os.path.join(ROOT, "examples", n)
                      for n in os.listdir(os.path.join(ROOT, "examples"))
                      if n.endswith("_torch.py"))
    return sorted(out) + examples + [os.path.join(ROOT, "chip_smoke.py")]


def _modules():
    mods = []
    for path in _port_files():
        if not path.startswith(PORT + os.sep):
            continue
        rel = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3]
        parts = rel.split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _examples():
    """The port's example programs, as module names (examples/ on the
    path)."""
    return [os.path.basename(p)[:-3] for p in _port_files()
            if os.path.dirname(p) == os.path.join(ROOT, "examples")]


def test_no_source_line_imports_jax_or_the_reference():
    bad = []
    for path in _port_files():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if IMPORT_RE.match(line):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{i}: "
                               f"{line.strip()}")
    assert not bad, "\n".join(bad)


def test_serving_modules_and_examples_are_scanned():
    """This slice's modules and the port's examples are among the scanned
    files (the import scan and the import check cover them)."""
    files = _port_files()
    for rel in ("models/moe.py", "models/rglru.py", "serve/serve_step.py",
                "serve/terra_decode.py", "serve/engine.py"):
        assert os.path.join(PORT, *rel.split("/")) in files, rel
    assert set(_examples()) >= {"serve_demo_torch", "train_lm_torch"}


def test_training_modules_are_scanned_and_import_no_jax():
    """The programs, the trainer stack and the sharding policy are among
    the scanned files (the scan above and the import check below cover
    them), and none of them names JAX or the reference at all."""
    files = _port_files()
    want = [os.path.join(PORT, "programs.py"),
            os.path.join(PORT, "parallel", "sharding.py")] + [
        os.path.join(PORT, "train", n) for n in
        ("checkpoint.py", "data.py", "optimizer.py", "train_step.py",
         "trainer.py")]
    for path in want:
        assert path in files, path
        with open(path) as f:
            src = f.read()
        assert not re.search(r"\bimport jax|\bfrom jax\b|\bml_dtypes\b|"
                             r"\bfrom repro\.|\bimport repro\b", src), path


def test_cross_attention_modules_are_scanned_and_import_no_jax():
    """The cross-attention slice's configs, model and serving modules,
    the port's serving example and ``chip_smoke.py`` (which holds the
    whisper scoring program) are among the scanned files, and none of
    them names JAX or the reference at all."""
    files = _port_files()
    want = [os.path.join(PORT, *rel.split("/")) for rel in (
        "configs/whisper_small.py", "configs/llama32_vision_90b.py",
        "configs/registry.py", "models/attention.py",
        "models/transformer.py", "models/model.py", "serve/serve_step.py",
        "serve/terra_decode.py", "serve/engine.py")]
    want += [os.path.join(ROOT, "examples", "serve_demo_torch.py"),
             os.path.join(ROOT, "chip_smoke.py")]
    for path in want:
        assert path in files, path
        with open(path) as f:
            src = f.read()
        assert not re.search(r"\bimport jax|\bfrom jax\b|"
                             r"\bfrom repro\.|\bimport repro\b", src), path


def test_persist_and_obs_modules_are_scanned_and_import_no_jax():
    """The persistence and observability modules (core/persist/, obs/,
    the scheduler checkpoint, the event schema) are among the scanned
    files, and none of them names JAX, ml_dtypes or the reference."""
    files = _port_files()
    want = [os.path.join(PORT, "core", "persist", n) for n in (
        "__init__.py", "aot.py", "checkpoint.py", "codec.py", "keys.py",
        "store.py", "warmboot.py")]
    want += [os.path.join(PORT, "obs", n) for n in (
        "__init__.py", "http.py", "metrics.py", "report.py",
        "trace_viewer.py")]
    want += [os.path.join(PORT, "serve", "scheduler", "checkpoint.py"),
             os.path.join(PORT, "core", "events", "schema.py")]
    for path in want:
        assert path in files, path
        with open(path) as f:
            src = f.read()
        assert not re.search(r"\bimport jax|\bfrom jax\b|\bml_dtypes\b|"
                             r"\bfrom repro\.|\bimport repro\b", src), path


def test_executor_passes_scheduler_events_kernels_modules_stay_small():
    """The reference's decomposition contract (tests/test_executor.py),
    held for the port's counterparts."""
    for pkg in ("core/executor", "core/passes", "serve/scheduler",
                "core/events", "kernels", "obs"):
        pkg_dir = os.path.join(PORT, pkg)
        for name in os.listdir(pkg_dir):
            if name.endswith(".py"):
                with open(os.path.join(pkg_dir, name)) as f:
                    n = sum(1 for _ in f)
                assert n <= 360, f"{pkg}/{name} has {n} lines"


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}, "
        f"{os.path.join(ROOT, 'examples')!r}]\n"
        f"for m in {_modules()!r} + {_examples()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LOADED', len(sys.modules))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED" in out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    from repro_torch.configs import smoke_config
    from repro_torch.core import function, imperative, ops
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    def body(x):
        return ops.reduce_sum(x)

    with pytest.raises(RuntimeError, match="CUDA"):
        function(body)
    with pytest.raises(RuntimeError, match="CUDA"):
        with imperative():
            pass
    cfg = smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingScheduler(cfg, params, max_slots=2, max_len=32)
    # asked for explicitly, the CPU works
    step = function(body, device="cpu")
    assert float(step(np.ones(3, np.float32))) == 3.0
    step.close()
    s = ContinuousBatchingScheduler(cfg, params, max_slots=2, max_len=32,
                                    device="cpu")
    s.close()


def test_training_entry_points_raise_without_cuda_unless_cpu_is_asked(
        no_cuda, tmp_path):
    from repro_torch import programs
    from repro_torch.configs import smoke_config
    from repro_torch.core import GradientTape, imperative, ops
    from repro_torch.train.trainer import Trainer

    cfg = smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, use_terra=False)
    for name in sorted(programs.REGISTRY):
        with pytest.raises(RuntimeError, match="CUDA"):
            programs.REGISTRY[name]("terra")
    with pytest.raises(RuntimeError, match="CUDA"):
        with imperative():
            pass
    # asked for explicitly, the CPU works
    tr = Trainer(cfg, batch=2, seq_len=8, log_every=1, device="cpu")
    assert np.isfinite(tr.train(2, verbose=False)[-1][1])
    tr._iteration.close()
    step, _ = programs.REGISTRY["resnet"]("imperative", device="cpu")
    with imperative(device="cpu") as imp:
        assert np.isfinite(float(step(0)))
        imp.step()
        w = ops.identity(np.ones(2, np.float32))
        with GradientTape() as tape:
            loss = ops.reduce_sum(ops.square(w))
        assert tape.gradient(loss, [w])[0].numpy().tolist() == [2.0, 2.0]


def test_kernel_wrappers_never_fall_back_for_device_tensors(monkeypatch):
    """A non-CPU tensor reaching a kernel wrapper launches its kernel or
    raises; the plain version runs only for CPU tensors."""
    from repro_torch.kernels import ops as kops
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(NotImplementedError):
        kops.rmsnorm(x, torch.zeros(4, device="meta"))
    q = torch.zeros(1, 1, 2, 16, device="meta")
    kv = torch.zeros(3, 4, 2, 16, device="meta")
    bt = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    vl = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kops.paged_attention(q, kv, kv, bt, vl)
    # the SSD scan and the model function that reaches it: a meta tensor
    # raises, and the plain versions never run for it
    from repro_torch.models import ssm
    ssd_mod = sys.modules["repro_torch.kernels.ssd_scan"]
    x = torch.zeros(1, 8, 2, 16, device="meta")
    dt = torch.zeros(1, 8, 2, device="meta")
    a = torch.zeros(2, device="meta")
    bc = torch.zeros(1, 8, 16, device="meta")
    ran = []
    monkeypatch.setattr(ssd_mod, "ref_ssd", lambda *a, **k: ran.append(1))
    monkeypatch.setattr(ssm, "ssd_chunked_plain",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(NotImplementedError):
        kops.ssd_scan(x, dt, a, bc, bc, return_final=True)
    with pytest.raises(NotImplementedError):
        ssm.ssd_chunked(x, dt, a, bc, bc, 4, return_final=True)
    assert not ran


def test_chip_smoke_refuses_without_cuda_or_outside_a_checkout(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        lone.write_text(f.read())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.cuda
def test_cuda_random_bits_equal_the_cpu_bits():
    """The random ops' counter hash makes the same bits on the card and
    the CPU, so a dropout mask does not depend on the device.  The kept
    values' division by (1 - rate) may round differently on the card, by
    at most one float32 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py compares dropblock's "
                    "losses card vs CPU there")
    from repro_torch.core import ops as tops
    key = tops.draw_key(torch.Generator().manual_seed(2))
    cpu = tops._random_bits(key, 1 << 20)
    card = tops._random_bits(key.cuda(), 1 << 20)
    assert torch.equal(card.cpu(), cpu)
    x = torch.randn(64, 1024)
    on_card = tops.op_impl("dropout")(x.cuda(), key.cuda(), rate=0.1).cpu()
    on_cpu = tops.op_impl("dropout")(x, key, rate=0.1)
    assert torch.equal(on_card != 0, on_cpu != 0)
    torch.testing.assert_close(on_card, on_cpu, rtol=2 ** -23, atol=0)
