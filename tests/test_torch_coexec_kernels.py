"""The imperative llama scoring program under co-execution with kernel
substitution, through the JAX package and through the port.

``chip_smoke.llama_score_program`` is one text written against the op
layer; here it runs at ``smoke_config("llama3-8b")`` with 2 layers in
float32 on the CPU, with parameters made by the JAX package's
``init_params`` and carried to the port by ``models/convert``.  Scores,
last-position logits and the engine's pass counters must agree; the
logits must equal the JAX model's ``prefill``.  The kernel ops run their
plain versions here (the port) and interpret-mode Pallas (the reference);
on the card ``chip_smoke.py`` runs the same program with the Hopper
kernels.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import reference_view  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_PIPE = ("fold", "cse", "kernels", "dce", "coalesce")
NO_FOLD = ("cse", "kernels", "dce", "coalesce")
COUNTERS = ("kernels_substituted", "feeds_folded", "nodes_eliminated",
            "cse_hits", "segments_coalesced", "replays", "retraces",
            "graph_versions", "iterations", "traced_iterations", "phase")
N_LAYERS, BATCH, SEQ, ITERS = 2, 2, 16, 5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    replace = dict(n_layers=N_LAYERS, dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), **replace)
    tcfg = dataclasses.replace(t_smoke("llama3-8b"), **replace)
    assert dataclasses.asdict(jcfg) == reference_view(tcfg)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, i):
    r = np.random.RandomState(100 + i)
    return r.randint(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)


def _run(core, cfg, params, optimize, **kw):
    step = _chip_smoke().llama_score_program(core, cfg, params, BATCH, SEQ,
                                             optimize=optimize, **kw)
    outs = []
    try:
        for i in range(ITERS):
            scores, order, last = step(_tokens(cfg, i))
            outs.append((scores, order, np.asarray(last.numpy(), np.float64)))
        stats = {k: step.stats.get(k) for k in COUNTERS}
        stats["phase"] = step.phase
    finally:
        step.close()
    return outs, stats


def _count_plain_calls(monkeypatch):
    """Wrap the port's plain kernel versions with call counters: off the
    card each call stands for one kernel launch on it."""
    calls = {"rmsnorm": 0, "flash_attention": 0}
    for name, ref in (("rmsnorm", "ref_rmsnorm"),
                      ("flash_attention", "ref_attention")):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        orig = getattr(mod, ref)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, ref, counted)
    return calls


@pytest.mark.parametrize("optimize", [KERNEL_PIPE, NO_FOLD],
                         ids=["with_fold", "without_fold"])
def test_scoring_program_matches_reference(model, optimize, monkeypatch):
    jcfg, tcfg, jparams, tparams = model
    want, jstats = _run(jcore, jcfg, jparams, optimize)
    calls = _count_plain_calls(monkeypatch)
    got, tstats = _run(tcore, tcfg, tparams, optimize, device="cpu")
    for (ws, wo, wl), (gs, go, gl) in zip(want, got):
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_allclose(gl, wl, rtol=1e-4, atol=1e-4)
    assert tstats == jstats
    assert tstats["phase"] == "co-execution"
    # every rms_norm is substituted; the attention chain only when its
    # causal mask was folded into a constant the pass can evaluate
    n_attn = N_LAYERS if "fold" in optimize else 0
    assert tstats["kernels_substituted"] == 2 * N_LAYERS + 1 + n_attn
    # the launch counts chip_smoke.py asserts on the card
    compiled = tstats["iterations"] - tstats["traced_iterations"]
    assert compiled > 0
    assert calls == {"rmsnorm": compiled * (2 * N_LAYERS + 1),
                     "flash_attention": compiled * n_attn}


def test_unfused_program_is_llama_prefill(model):
    """Under ``optimize="none"`` the program's last-position logits are the
    JAX model's ``prefill`` logits at the same params, in both packages:
    the program is the llama3 forward pass."""
    jcfg, tcfg, jparams, tparams = model
    want = [np.asarray(JM.prefill(jcfg, jparams, jnp.asarray(_tokens(jcfg, i)),
                                  SEQ)[0], np.float64)
            for i in range(ITERS)]
    for core, cfg, params, kw in ((jcore, jcfg, jparams, {}),
                                  (tcore, tcfg, tparams, {"device": "cpu"})):
        outs, _ = _run(core, cfg, params, "none", **kw)
        for w, (_, _, last) in zip(want, outs):
            np.testing.assert_allclose(last, w, rtol=1e-4, atol=1e-4)


LATE_FETCH = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, torch
    sys.path[:0] = [{src!r}, {root!r}]
    import chip_smoke
    import repro_torch.core as core
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(smoke_config("llama3-8b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    step = chip_smoke.llama_score_program(core, cfg, params, {b}, {s},
                                          optimize="safe", device="cpu")
    for i in range({n}):
        _, _, last = step(np.random.RandomState(100 + i).randint(
            0, cfg.vocab, ({b}, {s})).astype(np.int32))
    last.numpy()                 # first fetch of this value: after the call
    print(json.dumps({{k: step.stats.get(k) for k in {keys!r}}}))
    step.close()
""")


def test_late_fetch_replays_and_the_process_exits_cleanly(model):
    """Materialising a returned tensor only after its call has ended is a
    new fetch: both packages replay it and retrace.  The port's process
    then exits with 0 — closing the engine joins its GraphRunner thread,
    which a finalizing interpreter would otherwise abort inside torch."""
    jcfg, _, jparams, _ = model
    keys = ("iterations", "traced_iterations", "replays", "retraces")
    step = _chip_smoke().llama_score_program(jcore, jcfg, jparams, BATCH,
                                             SEQ, optimize="safe")
    for i in range(ITERS):
        _, _, last = step(_tokens(jcfg, i))
    last.numpy()
    want = {k: step.stats.get(k) for k in keys}
    step.close()
    code = LATE_FETCH.format(src=os.path.join(ROOT, "src"), root=ROOT,
                             b=BATCH, s=SEQ, n=ITERS, keys=keys)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == want
    assert want["replays"] == 1 and want["retraces"] == 1
