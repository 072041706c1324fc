"""The port's RG-LRU block against the JAX reference's, on the CPU.

Smoke widths in float32, reference parameters converted with
``params_from_jax``, inputs from numpy seeds; tolerance 1e-4 relative.
Three modes: a full sequence (S = 1024, where the log-depth scan must
stay stable over many decays), the S == 1 decode update from a cache,
and a prefill that starts from a state ``h0`` (S > 1 with a cache).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def block():
    jcfg = dataclasses.replace(j_smoke("recurrentgemma-2b"), **F32)
    tcfg = dataclasses.replace(t_smoke("recurrentgemma-2b"), **F32)
    jp = JT._rglru_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _x(B, S, d, seed):
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


def _cache(jcfg, B, seed):
    rng = np.random.RandomState(seed)
    K, dr = jcfg.conv_kernel, jcfg.rglru_width
    return {"conv": rng.randn(B, K - 1, dr).astype(np.float32),
            "h": rng.randn(B, dr).astype(np.float32)}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_full_sequence_matches_reference(block):
    jcfg, tcfg, jp, tp = block
    x = _x(2, 1024, jcfg.d_model, 0)
    want, wc = JR.rglru_block(jp, jnp.asarray(x), jcfg)
    got, tc = TR.rglru_block(tp, torch.from_numpy(x), tcfg)
    assert wc is None and tc is None
    _close(got.numpy(), want)


@pytest.mark.parametrize("S", [1, 7])
def test_cached_step_matches_reference(block, S):
    """S == 1: the decode update; S == 7: a prefill from a state h0."""
    jcfg, tcfg, jp, tp = block
    x = _x(3, S, jcfg.d_model, S)
    c = _cache(jcfg, 3, 10 + S)
    want, wc = JR.rglru_block(jp, jnp.asarray(x), jcfg,
                              cache={k: jnp.asarray(v) for k, v in c.items()})
    got, tc = TR.rglru_block(tp, torch.from_numpy(x), tcfg,
                             cache={k: torch.from_numpy(v)
                                    for k, v in c.items()})
    _close(got.numpy(), want)
    for k in ("conv", "h"):
        _close(tc[k].numpy(), wc[k])
    assert tc["h"].dtype == torch.float32


def test_scan_equals_the_sequential_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + x_t step by step,
    with decays near 0 and near 1 and a state h0."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 300, 5).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 300, 5))
                         .astype(np.float32) ** 0.1)
    h0 = torch.from_numpy(rng.randn(2, 5).astype(np.float32))
    got = TR.rg_lru_scan(x, a, h0)
    h, rows = h0, []
    for t in range(x.shape[1]):
        h = a[:, t] * h + x[:, t]
        rows.append(h)
    torch.testing.assert_close(got, torch.stack(rows, 1), rtol=1e-5,
                               atol=1e-5)
