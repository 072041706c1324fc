"""The port's examples against the reference's, on the CPU.

``examples/{quickstart,coexec_showcase,serve_continuous}_torch.py`` run
their ``main()`` with ``--device cpu``:

* serve_continuous: what ``tests/test_examples.py`` asserts of the
  reference's (every request retired, co-execution, no retrace);
* quickstart: the printed losses equal the reference example's within
  1e-5 and so do its int stats;
* coexec_showcase: the losses of iterations 0-7 (noise 0.0 there: the
  random draws differ by design, ROADMAP "Random draws") and the int
  stats of all 16 iterations.

Both packages' examples keep module state (variables, the mutated
schedule), so each module is loaded afresh for its run.
"""

import ast
import importlib
import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _examples_importable(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the reference comparisons run with JAX on the CPU")
    return jax


def _run(name, argv, monkeypatch, capsys):
    """``examples/<name>.py``'s main() on a freshly loaded module."""
    mod = importlib.reload(importlib.import_module(f"examples.{name}"))
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _losses(out, pattern):
    return [float(m) for m in re.findall(pattern, out)]


def _stats(out):
    line = [ln for ln in out.splitlines() if ln.startswith("stats:")][-1]
    return ast.literal_eval(line[len("stats:"):].strip())


def test_serve_continuous_main_path(monkeypatch, capsys):
    out = _run("serve_continuous_torch",
               ["--arch", "llama3-8b", "--requests", "4", "--max-slots", "2",
                "--max-len", "64", "--mean-gap-ms", "1", "--device", "cpu"],
               monkeypatch, capsys)
    assert "retired=4" in out
    assert "phase=co-execution" in out
    assert "retraces=0" in out


def test_quickstart_matches_the_reference(jax_ref, monkeypatch, capsys):
    theirs = _run("quickstart", [], monkeypatch, capsys)
    mine = _run("quickstart_torch", ["--device", "cpu"], monkeypatch, capsys)
    pat = r"loss (-?[0-9.]+)"
    lt, lj = _losses(mine, pat), _losses(theirs, pat)
    assert len(lt) == len(lj) == 6
    assert max(abs(a - b) for a, b in zip(lt, lj)) <= 1e-5
    assert re.findall(r"phase=(\S+)", mine) == \
        re.findall(r"phase=(\S+)", theirs)
    assert _stats(mine) == _stats(theirs)
    assert _stats(mine)["replays"] >= 1


def test_coexec_showcase_matches_the_reference(jax_ref, monkeypatch, capsys):
    theirs = _run("coexec_showcase", [], monkeypatch, capsys)
    mine = _run("coexec_showcase_torch", ["--device", "cpu"], monkeypatch,
                capsys)
    pat = r"loss=\s*(-?[0-9.]+)"
    lt, lj = _losses(mine, pat), _losses(theirs, pat)
    assert len(lt) == len(lj) == 16
    assert max(abs(a - b) for a, b in zip(lt[:8], lj[:8])) <= 1e-5
    assert re.findall(r"phase=(\S+)", mine) == \
        re.findall(r"phase=(\S+)", theirs)
    assert _stats(mine) == _stats(theirs)
