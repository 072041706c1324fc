"""Nothing the benchmark runs imports JAX or the JAX package: module
names compared by their whole top-level name (``repro_torch``, the port,
begins with ``repro`` and is allowed)."""

import ast
import os
import subprocess
import sys

from portbench.core import env

BASE = os.path.join(env.ROOT, "portbench")


def _sources():
    for d, _, files in os.walk(BASE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_forbidden_names_are_compared_whole():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "reprox": 1,
            "jaxtyping": 1, "repro": 1, "repro.core": 1, "jax.numpy": 1,
            "flax": 1}
    assert env.forbidden_loaded(mods) == ["flax", "jax.numpy", "repro",
                                          "repro.core"]


def test_no_source_under_paths_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(open(path).read())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                names = [node.module]
            bad += [(path, n) for n in names
                    if n.split(".")[0] in env.FORBIDDEN]
    assert bad == []


def test_a_process_running_the_harness_loads_neither():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.core import env; env.prepare()\n"
        "import importlib, pkgutil, portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name and not m.name.endswith(('run', "
        "'control', 'sweep')):\n"
        "        importlib.import_module(m.name)\n"
        "import repro_torch.serve.scheduler, repro_torch.train.trainer\n"
        "import repro_torch.kernels.ops\n"
        "print(env.forbidden_loaded())\n" % env.ROOT)
    envv = dict(os.environ)
    envv["PYTHONPATH"] = os.pathsep.join([env.SRC, env.ROOT])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=envv, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    envv = dict(os.environ)
    envv["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, os.path.join(BASE, "run.py"), "--workload",
         "mamba2-130m.train-16x2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=envv,
        timeout=300, cwd=env.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
