"""The imperative whisper scoring program under co-execution with kernel
substitution, through the JAX package and through the port.

``chip_smoke.whisper_score_program`` scores candidate transcripts against
audio (n-best rescoring), written once against the op layer.  Here it runs
at ``smoke_config("whisper-small")`` (one encoder and one decoder layer,
24 frames) in float32 on the CPU, with the reference's parameters carried
to the port by ``models/convert``.  Under the ``kernels`` pass each pair of
an encoder and a decoder layer gives three ``kernel.attention`` nodes: the
encoder's bidirectional attention (frames x frames), the decoder's causal
one (its mask folded from a positions feed) and its cross-attention
(transcript x frames).  Scores, ranking, last-position logits and the
engine's pass counters must agree with the reference's (tolerance 1e-4,
as ``test_torch_coexec_kernels.py``); the kernel ops run their plain
versions here (the port) and interpret-mode Pallas (the reference), and
each plain call stands for a launch on the card.  Unfused, the program's
last logits are the JAX model's forward.
"""

import dataclasses
import importlib
import importlib.util
import os

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
BATCH, SEQ, ITERS = 2, 16, 5


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
    f32 = dict(dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(j_smoke("whisper-small"), **f32)
    tcfg = dataclasses.replace(t_smoke("whisper-small"), **f32)
    assert dataclasses.asdict(jcfg) == reference_view(tcfg)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _inputs(cfg, i):
    r = np.random.RandomState(100 + i)
    return (r.randint(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32),
            r.randn(BATCH, cfg.frontend_tokens, cfg.d_model)
            .astype(np.float32))


def _run(core, cfg, params, optimize, **kw):
    step = _chip_smoke().whisper_score_program(
        core, cfg, params, BATCH, SEQ, cfg.frontend_tokens,
        optimize=optimize, **kw)
    outs = []
    try:
        for i in range(ITERS):
            scores, order, last = step(*_inputs(cfg, i))
            outs.append((scores, order, np.asarray(last.numpy(), np.float64)))
        stats = {k: step.stats.get(k) for k in COUNTERS}
        stats["phase"] = step.phase
    finally:
        step.close()
    return outs, stats


def _count_flash_calls(monkeypatch):
    """Wrap the port's plain attention with a call counter: off the card
    each call stands for one flash launch on it."""
    calls = {"flash_attention": 0}
    mod = importlib.import_module("repro_torch.kernels.flash_attention")
    orig = mod.ref_attention

    def counted(*a, **kw):
        calls["flash_attention"] += 1
        return orig(*a, **kw)
    monkeypatch.setattr(mod, "ref_attention", counted)
    return calls


@pytest.mark.parametrize("optimize", [KERNEL_PIPE, NO_FOLD],
                         ids=["with_fold", "without_fold"])
def test_whisper_scoring_matches_reference(model, optimize, monkeypatch):
    jcfg, tcfg, jparams, tparams = model
    want, jstats = _run(jcore, jcfg, jparams, optimize)
    calls = _count_flash_calls(monkeypatch)
    got, tstats = _run(tcore, tcfg, tparams, optimize, device="cpu")
    for (ws, wo, wl), (gs, go, gl) in zip(want, got):
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_allclose(gl, wl, rtol=1e-4, atol=1e-4)
    assert tstats == jstats
    assert tstats["phase"] == "co-execution"
    # the encoder's and the cross attention carry no bias and match in
    # either pipeline; the decoder's causal one only once its mask is
    # folded into a constant the pass can evaluate
    per_pair = 3 if "fold" in optimize else 2
    assert tstats["kernels_substituted"] == per_pair * tcfg.n_layers
    compiled = tstats["iterations"] - tstats["traced_iterations"]
    assert compiled > 0
    assert calls == {"flash_attention": compiled * per_pair * tcfg.n_layers}


def test_unfused_whisper_program_is_the_model_forward(model):
    """Under ``optimize="none"`` the program's last-position logits are the
    JAX model's ``forward`` with ``frontend_embeds`` at the same params,
    in both packages: the program is the whisper model."""
    jcfg, tcfg, jparams, tparams = model
    want = []
    for i in range(ITERS):
        tok, audio = _inputs(jcfg, i)
        logits = JM.forward(jcfg, jparams, jnp.asarray(tok),
                            frontend_embeds=jnp.asarray(audio))
        want.append(np.asarray(logits, np.float64)[:, -1])
    for core, cfg, params, kw in ((jcore, jcfg, jparams, {}),
                                  (tcore, tcfg, tparams, {"device": "cpu"})):
        outs, _ = _run(core, cfg, params, "none", **kw)
        for w, (_, _, last) in zip(want, outs):
            np.testing.assert_allclose(last, w, rtol=1e-4, atol=1e-4)


def test_scores_depend_on_the_audio(model):
    """The same transcripts against other audio score otherwise: the
    decoder reads the encoder states."""
    _, tcfg, _, tparams = model
    step = _chip_smoke().whisper_score_program(
        tcore, tcfg, tparams, BATCH, SEQ, tcfg.frontend_tokens,
        optimize=KERNEL_PIPE, device="cpu")
    try:
        tok, audio = _inputs(tcfg, 0)
        a, _, _ = step(tok, audio)
        b, _, _ = step(tok, audio[::-1].copy())
        c, _, _ = step(tok, audio)
    finally:
        step.close()
    np.testing.assert_array_equal(a, c)
    assert np.abs(a - b).max() > 1e-4
