"""The paper's ten imperative programs: the port's ``repro_torch.programs``
against the reference's ``benchmarks/programs.py``.

Each program runs 20 iterations in each variant through both packages
("terra" through ``function``, "imperative" inside ``imperative()``), from
the same ``np.random.RandomState`` weights and batches: the losses must
agree (f32: rtol 1e-4, atol 1e-5) and the engine counters must be equal.
dropblock draws a dropout mask from iteration 5 on, which cannot match
``jax.random``'s, so from there it compares counters only.  The port runs
with ``device="cpu"``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from benchmarks import programs as jprog  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402

ITERS = 20
RTOL, ATOL = 1e-4, 1e-5
RANDOM_FROM = {"dropblock": 5}         # first iteration that draws
KEYS = ("retraces", "replays", "graph_versions", "traced_iterations",
        "iterations", "transitions", "families", "family_switches",
        "replayed_entries", "segments_dispatched", "segments_recompiled",
        "walker_fast_hits", "steady_iters")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run(core, registry, name, variant, **kw):
    """-> (losses, engine counters with the phase)."""
    step, _ = registry[name](variant, **kw)
    if variant == "terra":
        tf = core.function(step, **kw)
        try:
            losses = [float(tf(i)) for i in range(ITERS)]
            tf.wait()
            stats = {k: tf.stats.get(k) for k in KEYS} | {"phase": tf.phase}
        finally:
            tf.close()
        return losses, stats
    losses = []
    with core.imperative(**kw) as imp:
        for i in range(ITERS):
            losses.append(float(step(i)))
            imp.step()
        stats = {k: imp.engine.stats.get(k) for k in KEYS}
    return losses, stats


def test_the_registries_hold_the_same_ten_programs():
    assert sorted(tprog.REGISTRY) == sorted(jprog.REGISTRY)
    assert len(tprog.REGISTRY) == 10
    assert tprog.NON_CONVERTIBLE == jprog.NON_CONVERTIBLE
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tprog.REGISTRY["gpt2"]("fulljit", device="cpu")
    with pytest.raises(ValueError):
        tprog.REGISTRY["gpt2"]("eager", device="cpu")


@pytest.mark.parametrize("variant", ["terra", "imperative"])
@pytest.mark.parametrize("name", sorted(jprog.REGISTRY))
def test_program_matches_reference(name, variant):
    want, jstats = run(jcore, jprog.REGISTRY, name, variant)
    got, tstats = run(tcore, tprog.REGISTRY, name, variant, device="cpu")
    n = RANDOM_FROM.get(name, ITERS)
    np.testing.assert_allclose(got[:n], want[:n], rtol=RTOL, atol=ATOL)
    assert np.all(np.isfinite(got))
    assert tstats == jstats
    if variant == "terra":
        assert tstats["phase"] == "co-execution"
