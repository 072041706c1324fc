"""The port's MoE block against the JAX reference's, on the CPU.

Smoke widths in float32, reference parameters converted with
``params_from_jax``, inputs from numpy seeds; tolerance 1e-4 relative.
The cases: routed experts alone, routed plus shared experts, and a
capacity small enough that full experts drop tokens (which tokens drop is
decided by the router's top-k, including its tie order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32")

# (arch, config overrides): deepseek carries a shared expert, mixtral none;
# capacity_factor 0.5 gives C = 8 slots for 32 tokens x top-2 over 4
# experts, so full experts drop tokens
CASES = {
    "routed": ("mixtral-8x22b", {}),
    "shared": ("deepseek-moe-16b", {}),
    "drops": ("deepseek-moe-16b", dict(capacity_factor=0.5)),
    "drops-routed": ("mixtral-8x22b", dict(capacity_factor=0.5)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_smoke(arch), **F32, **kw),
            dataclasses.replace(t_smoke(arch), **F32, **kw))


def _moe_params(jcfg, seed=0):
    jp = JT._moe_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_block_matches_reference(case):
    arch, kw = CASES[case]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _moe_params(jcfg)
    x = np.random.RandomState(1).randn(2, 16, jcfg.d_model).astype(
        np.float32)
    want = np.asarray(JMOE.moe_block(jp, jnp.asarray(x), jcfg))
    got = TMOE.moe_block(tp, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    T = x.shape[0] * x.shape[1]
    C = TMOE.capacity(tcfg, T)
    if case.startswith("drops"):
        # some expert really is over capacity at these inputs
        logits = torch.from_numpy(x.reshape(T, -1)) @ tp["w_router"]
        _, ids = TMOE.route(logits, tcfg.top_k)
        load = torch.bincount(ids.reshape(-1), minlength=tcfg.n_experts)
        assert int(load.max()) > C
    else:
        assert C == T


def test_router_ties_pick_the_lower_expert_as_jax_top_k_does():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0]])
    w, ids = TMOE.route(logits, 2)
    jv, jids = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jax.nn.softmax(jv, axis=-1)), rtol=1e-6)


def test_moe_params_mirror_the_reference_layout():
    """Leaf paths, shapes and dtypes of a moe block equal the reference's
    (the router stays float32 under bfloat16 params)."""
    for arch in ("deepseek-moe-16b", "mixtral-8x22b"):
        jcfg = j_smoke(arch)
        tcfg = t_smoke(arch)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tp = TT.init_params(tcfg, device="cpu")
        jl = jax.tree_util.tree_leaves_with_path(jp)
        from repro_torch.core.pytree import tree_leaves
        tl = tree_leaves(tp)
        assert len(jl) == len(tl)
        for (path, a), b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path


def test_param_counts_equal_the_reference():
    from repro.configs import get_config as jg
    from repro.models import model as JMM
    from repro_torch.configs import get_config as tg
    for arch in ("deepseek-moe-16b", "mixtral-8x22b", "recurrentgemma-2b",
                 "qwen2.5-14b"):
        assert TM.param_count(tg(arch)) == JMM.param_count(jg(arch))
        assert TM.active_param_count(tg(arch)) == \
            JMM.active_param_count(jg(arch))


def test_shard_map_moe_raises_naming_the_parallel_slice():
    """(Name kept from when expert parallelism was a stub that raised.)
    ``moe_impl="shard_map"`` is ``models/moe_ep.py`` now; without a mesh
    it is the ``moe_block`` path, as the reference's ``moe_block_ep``
    falls back, so the logits equal the default impl's exactly.  The
    mesh path runs in ``tests/test_torch_parallel.py``."""
    _, tcfg = _cfgs("mixtral-8x22b", moe_impl="shard_map")
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, tcfg.vocab, (2, 8)).astype(np.int32))
    got = TM.forward(tcfg, params, tokens)
    want = TM.forward(dataclasses.replace(tcfg, moe_impl="pjit"), params,
                      tokens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
