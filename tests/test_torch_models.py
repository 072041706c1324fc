"""The port's llama-family model functions against the JAX reference.

Params come from the reference's ``init_params`` (converted with
``params_from_jax``), inputs from numpy seeds; ``smoke_config("llama3-8b")``
switched to float32, tolerance 1e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import reference_view  # noqa: E402
from repro_torch.core.pytree import tree_flatten  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
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
def llama():
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), **F32)
    tcfg = dataclasses.replace(t_smoke("llama3-8b"), **F32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_configs_are_the_reference_configs():
    # reference_view: the reference's fields, each port-only field
    # checked at its default (the port's schema has fields it lacks)
    assert reference_view(t_smoke("llama3-8b")) == \
        dataclasses.asdict(j_smoke("llama3-8b"))
    from repro.configs import get_config as jg
    from repro_torch.configs import get_config as tg
    assert reference_view(tg("llama3-8b")) == \
        dataclasses.asdict(jg("llama3-8b"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_round_trip(dtype):
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), dtype=dtype,
                               param_dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jl, jdef = jax.tree_util.tree_flatten_with_path(jp)
    tl, _ = tree_flatten(tp)
    assert len(tl) == len(jl)
    for (path, a), t in zip(jl, tl):
        assert tuple(t.shape) == a.shape, jax.tree_util.keystr(path)
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))


def test_port_init_params_mirror_the_reference_layout():
    """Same nesting, leaf order, shapes and dtypes as the reference's
    init_params, so pool Variables line up leaf for leaf."""
    cfg = t_smoke("llama3-8b")
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = JM.init_params(j_smoke("llama3-8b"), jax.random.PRNGKey(0))
    tl, tdef = tree_flatten(tp)
    jl = jax.tree_util.tree_leaves(jp)
    assert [tuple(t.shape) for t in tl] == [a.shape for a in jl]
    assert all(str(t.dtype) == "torch.bfloat16" for t in tl)
    assert tdef == tree_flatten(params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"))[1]
    with pytest.raises(ValueError):
        TM.init_params(cfg, torch.Generator().manual_seed(0),
                       device="meta")


def test_embed_rope_rms_norm(llama):
    jcfg, tcfg, jp, tp = llama
    ids = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 5)).astype(
        np.int32)
    _close(TL.embed(tp["embed"], torch.from_numpy(ids)),
           JL.embed(jp["embed"], jnp.asarray(ids)), 0)
    x = _x((2, 5, 4, 16), 1)
    pos = np.arange(5)[None]
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    h = _x((2, 5, 64), 2)
    s = _x((64,), 3)
    _close(TL.rms_norm(torch.from_numpy(h), torch.from_numpy(s)),
           JL.rms_norm(jnp.asarray(h), jnp.asarray(s)))


def test_attention_block_no_cache(llama):
    jcfg, tcfg, jp, tp = llama
    x = _x((2, 8, 64), 4)
    p_j = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    p_t = {k: v[0] for k, v in tp["blocks"][0]["attn"].items()}
    got, _ = TA.attention_block(p_t, torch.from_numpy(x), tcfg)
    want, _ = JA.attention_block(p_j, jnp.asarray(x), jcfg)
    _close(got, want)


def test_run_stack_prefill_with_cache(llama):
    jcfg, tcfg, jp, tp = llama
    B, S, L = 2, 6, 16
    x = _x((B, S, 64), 5)
    jc = JM.init_cache(jcfg, B, L)
    tc = TM.init_cache(tcfg, B, L, "cpu")
    pos = np.arange(S)[None]
    got, tnew = TT.run_stack(tcfg, tp, torch.from_numpy(x),
                             positions=torch.from_numpy(pos), caches=tc)
    want, jnew = JT.run_stack(jcfg, jp, jnp.asarray(x),
                              positions=jnp.asarray(pos), caches=jc)
    _close(got, want)
    assert tnew["len"] == int(jnew["len"]) == S
    for a, b in zip(tree_flatten(tnew["layers"])[0],
                    jax.tree_util.tree_leaves(jnew["layers"])):
        _close(a, b)


def test_prefill_and_decode_step_logits(llama):
    jcfg, tcfg, jp, tp = llama
    ids = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 7)).astype(
        np.int32)
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(ids), 16)
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(ids), 16)
    _close(tl, jl)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    tl2, _ = TM.decode_step(tcfg, tp, tc, torch.from_numpy(nxt))
    jl2, _ = JM.decode_step(jcfg, jp, jc, jnp.asarray(nxt))
    _close(tl2, jl2)


@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "kernel"])
def test_paged_single_token_decode(llama, kernel):
    """attention_block over a paged arena (vector positions, block table),
    through the gather path or the kernel wrapper's plain version, against
    the reference's paged gather path."""
    jcfg, tcfg, jp, tp = llama
    B, bs, nbps, nblk = 3, 4, 4, 13
    Hkv, D = tcfg.n_kv_heads, tcfg.head_dim
    r = np.random.RandomState(7)
    x = r.randn(B, 1, 64).astype(np.float32)
    kp = r.randn(nblk, bs, Hkv, D).astype(np.float32)
    vp = r.randn(nblk, bs, Hkv, D).astype(np.float32)
    bt = np.zeros((B, nbps), np.int32)
    bt[:, :3] = r.permutation(np.arange(1, nblk))[:9].reshape(B, 3)
    pos = np.array([0, 5, 11], np.int32)
    p_j = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    p_t = {k: v[0] for k, v in tp["blocks"][0]["attn"].items()}
    jcache = {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
              "bt": jnp.asarray(bt), "len": jnp.asarray(pos)}
    tcache = {"kp": torch.from_numpy(kp), "vp": torch.from_numpy(vp),
              "bt": torch.from_numpy(bt), "len": torch.from_numpy(pos)}
    want, jnew = JA.attention_block(p_j, jnp.asarray(x), jcfg,
                                    positions=jnp.asarray(pos)[:, None],
                                    cache=jcache)
    if kernel:
        with TA.paged_kernel():
            got, tnew = TA.attention_block(
                p_t, torch.from_numpy(x), tcfg,
                positions=torch.from_numpy(pos)[:, None], cache=tcache)
    else:
        got, tnew = TA.attention_block(
            p_t, torch.from_numpy(x), tcfg,
            positions=torch.from_numpy(pos)[:, None], cache=tcache)
    _close(got, want)
    _close(tnew["kp"], jnew["kp"])
    _close(tnew["vp"], jnew["vp"])
    np.testing.assert_array_equal(tnew["len"].numpy(), np.asarray(jnew["len"]))
    # the pool buffers handed in are never written in place
    np.testing.assert_array_equal(tcache["kp"].numpy(), kp)


def test_unported_block_kinds_raise():
    """Every block kind of the reference now ports (the cross-attention
    slice brought ``cross``, ``dec_attn_cross`` and the encoder, as earlier
    slices ``moe`` and ``rglru``): tiny configs of both build with the
    reference's parameter layout and run its forward; only a kind the
    reference does not know raises."""
    from repro.configs.base import ModelConfig as JConfig
    from repro_torch.configs.base import ModelConfig
    base = dict(n_heads=2, n_kv_heads=1, d_ff=32, vocab=32, d_model=16,
                dtype="float32", param_dtype="float32", frontend_tokens=6)
    kinds = (dict(name="m", family="vlm", n_layers=2,
                  block_pattern=("attn", "cross")),
             dict(name="w", family="audio", n_layers=1, norm="ln",
                  block_pattern=("dec_attn_cross",), enc_layers=1))
    rng = np.random.RandomState(0)
    for kw in kinds:
        cfg, jcfg = ModelConfig(**base, **kw), JConfig(**base, **kw)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tp = TM.init_params(cfg, device="cpu")
        assert [tuple(a.shape) for a in tree_flatten(tp)[0]] == \
            [tuple(a.shape) for a in jax.tree.leaves(jp)]
        tok = rng.randint(0, 32, (2, 5)).astype(np.int32)
        side = rng.randn(2, 6, 16).astype(np.float32)
        key = "frontend_embeds" if cfg.enc_layers else "cross_states"
        want = JM.forward(jcfg, jp, jnp.asarray(tok), **{key: side})
        got = TM.forward(cfg, params_from_jax(
            jax.tree.map(np.asarray, jp), "cpu"), torch.from_numpy(tok),
            **{key: torch.from_numpy(side)})
        _close(got, want)
    bad = ModelConfig(**base, name="x", family="dense", n_layers=1,
                      block_pattern=("conv",))
    with pytest.raises(ValueError, match="conv"):
        TM.init_params(bad, device="cpu")


def test_mamba2_configs_are_the_reference_configs():
    assert reference_view(t_smoke("mamba2-130m")) == \
        dataclasses.asdict(j_smoke("mamba2-130m"))
    from repro.configs import get_config as jg
    from repro_torch.configs import get_config as tg
    assert reference_view(tg("mamba2-130m")) == \
        dataclasses.asdict(jg("mamba2-130m"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mamba2_init_params_mirror_the_reference_layout(dtype):
    """ssd blocks carry norm1 and ssd only; a_log stays float32 whatever
    param_dtype is; params_from_jax carries the reference's leaves over
    unchanged, in the same order."""
    kw = dict(dtype=dtype, param_dtype=dtype)
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"), **kw)
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"), **kw)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    assert sorted(tp["blocks"][0]) == ["norm1", "ssd"]
    assert tp["blocks"][0]["ssd"]["a_log"].dtype == torch.float32
    tl, tdef = tree_flatten(tp)
    jl = jax.tree_util.tree_leaves(jp)
    assert [tuple(t.shape) for t in tl] == [a.shape for a in jl]
    assert [str(t.dtype).replace("torch.", "") for t in tl] == \
        [str(a.dtype) for a in jl]
    conv = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tdef == tree_flatten(conv)[1]
    for t, a in zip(tree_flatten(conv)[0], jl):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.parametrize("page_size", [0, 8])
def test_mamba2_pool_cache_matches_the_reference(page_size):
    """The slot pool's recurrent leaves: conv window in cfg.dtype, state
    in float32, dense slot rows even under a page size."""
    from repro.serve.scheduler import pool_ops as JP
    from repro_torch.serve.scheduler import pool_ops as TP
    jl, _, jax_axes, jpaged = JP.build_pool_cache(j_smoke("mamba2-130m"), 3,
                                                  32, page_size, 13)
    tl, _, t_axes, tpaged = TP.build_pool_cache(t_smoke("mamba2-130m"), 3,
                                                32, page_size, 13, "cpu")
    assert [tuple(t.shape) for t in tl] == [a.shape for a in jl]
    assert [str(t.dtype).replace("torch.", "") for t in tl] == \
        [str(a.dtype) for a in jl]
    assert t_axes == jax_axes and tpaged == jpaged == (False, False)
    assert not TP.pads_allowed(t_smoke("mamba2-130m"))
