"""Cross-attention and the encoder, the port against the JAX reference, on
the CPU.

llama-3.2-vision-90b (gated ``cross`` blocks over vision states) and
whisper-small (an ``enc_attn`` encoder and ``dec_attn_cross`` decoder
blocks) at their smoke widths in float32, with the reference's parameters
converted by ``params_from_jax`` and numpy-seeded tokens, vision states
and frame embeddings.  The VLM's gates start at zero, which would hide the
cross-attention from every output, so both packages get the same seeded
non-zero gates.  Covered: the cross ``attention_block`` alone, each of the
three block kinds, ``encode``, ``forward`` with ``cross_states`` and with
``frontend_embeds``, prefill then one decode step against the reference's
and the port's own forward, one AdamW train step's loss and gradient norm
(the states ride in the batch as extras), and ``param_count``.  Tolerance
1e-4 relative, as ``test_torch_families.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import reference_view  # noqa: E402
from repro_torch.core.pytree import tree_flatten, tree_map  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

TOL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32")
VLM, WHISPER = "llama-3.2-vision-90b", "whisper-small"
_MODELS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def seed_gates(jp, cfg, seed=3):
    """The reference's params with every ``cross`` slot's gate set to
    seeded values (tanh(gate) scales the cross-attention's output)."""
    rng = np.random.RandomState(seed)
    blocks = list(jp["blocks"])
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "cross":
            g = blocks[i]["gate"]
            blocks[i] = {**blocks[i], "gate": jnp.asarray(
                rng.uniform(0.3, 1.0, g.shape), g.dtype)}
    return {**jp, "blocks": blocks}


def model(arch):
    """(jcfg, tcfg, reference params, port params), made once."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(j_smoke(arch), **F32)
        tcfg = dataclasses.replace(t_smoke(arch), **F32)
        assert dataclasses.asdict(jcfg) == reference_view(tcfg)
        jp = seed_gates(JM.init_params(jcfg, jax.random.PRNGKey(0)), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[arch] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch]


def side_input(cfg, batch=2, seed=1):
    """Seeded vision states or frame embeddings [batch, T, d] (f32)."""
    return np.random.RandomState(seed).randn(
        batch, cfg.frontend_tokens, cfg.d_model).astype(np.float32)


def tokens(cfg, batch=2, seq=12, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, (batch, seq)).astype(np.int32)


def _close(got, want, tol=TOL):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(g, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------
# registry and parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_configs_equal_the_reference(arch):
    assert reference_view(t_get(arch)) == dataclasses.asdict(j_get(arch))
    assert reference_view(t_smoke(arch)) == \
        dataclasses.asdict(j_smoke(arch))


@pytest.mark.parametrize("arch, layers, want", [
    (WHISPER, None, 335_715_840),
    (VLM, 10, None),
    (VLM, None, 87_666_794_516),
])
def test_param_count_matches_reference(arch, layers, want):
    tcfg, jcfg = t_get(arch), j_get(arch)
    if layers is not None:
        tcfg = dataclasses.replace(tcfg, n_layers=layers)
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
    got = TM.param_count(tcfg)
    assert got == JM.param_count(jcfg)
    if want is not None:
        assert got == want


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_params_have_the_reference_layout(arch):
    """Same nesting, leaf order, shapes and dtypes as the reference's
    ``init_params`` (so ``params_from_jax`` maps one onto the other), and
    the cross projections carry no bias even with ``qkv_bias``."""
    jcfg, tcfg, jp, _ = model(arch)
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    leaves, _ = tree_flatten(mine)
    jleaves = jax.tree.leaves(jp)
    assert [tuple(a.shape) for a in leaves] == \
        [tuple(a.shape) for a in jleaves]
    assert [str(a.dtype).replace("torch.", "") for a in leaves] == \
        [str(a.dtype) for a in jleaves]
    biased = dataclasses.replace(tcfg, qkv_bias=True)
    jbiased = dataclasses.replace(jcfg, qkv_bias=True)
    got = TM.init_params(biased, torch.Generator().manual_seed(0),
                         device="cpu")
    want = JM.init_params(jbiased, jax.random.PRNGKey(0))
    slot = tcfg.block_pattern.index("cross" if arch == VLM
                                    else "dec_attn_cross")
    assert sorted(got["blocks"][slot]["cross"]) == \
        sorted(want["blocks"][slot]["cross"]) == ["wk", "wo", "wq", "wv"]
    # slot 0's self-attention (VLM "attn", Whisper "dec_attn_cross") has it
    assert "bq" in got["blocks"][0]["attn"] and "bq" in want["blocks"][0]["attn"]


# --------------------------------------------------------------------------
# attention and blocks
# --------------------------------------------------------------------------

def test_cross_attention_block_matches_reference():
    """K/V from the states (Skv = their length), no rope, no cache, no
    causal mask."""
    jcfg, tcfg, jp, tp = model(VLM)
    slot = tcfg.block_pattern.index("cross")
    x = np.random.RandomState(4).randn(2, 9, jcfg.d_model).astype(np.float32)
    st = side_input(jcfg)
    pos = np.arange(9)[None] + 5
    jpp = jax.tree.map(lambda a: a[0], jp["blocks"][slot]["cross"])
    tpp = tree_map(lambda a: a[0], tp["blocks"][slot]["cross"])
    want, jc = JA.attention_block(jpp, jnp.asarray(x), jcfg,
                                  positions=jnp.asarray(pos),
                                  cross_states=jnp.asarray(st))
    got, tc = TA.attention_block(tpp, _t(x), tcfg, positions=_t(pos),
                                 cross_states=_t(st))
    assert jc is None and tc is None
    assert tuple(got.shape) == (2, 9, jcfg.d_model)
    _close(got, want)
    # the positions (and so rope) play no part
    again, _ = TA.attention_block(tpp, _t(x), tcfg, positions=_t(pos * 0),
                                  cross_states=_t(st))
    _close(again, got, 1e-6)


@pytest.mark.parametrize("arch, kind", [(WHISPER, "enc_attn"),
                                        (VLM, "cross"),
                                        (WHISPER, "dec_attn_cross")])
def test_block_kinds_match_reference(arch, kind):
    jcfg, tcfg, jp, tp = model(arch)
    x = np.random.RandomState(5).randn(2, 10, jcfg.d_model).astype(np.float32)
    st = side_input(jcfg)
    if kind == "enc_attn":
        jpp = jax.tree.map(lambda a: a[0], jp["encoder"])
        tpp = tree_map(lambda a: a[0], tp["encoder"])
    else:
        slot = jcfg.block_pattern.index(kind)
        jpp = jax.tree.map(lambda a: a[0], jp["blocks"][slot])
        tpp = tree_map(lambda a: a[0], tp["blocks"][slot])
    pos = np.arange(10)[None]
    kw = dict(causal=False) if kind == "enc_attn" else {}
    want, jc = JT.block_forward(jcfg, kind, jpp, jnp.asarray(x),
                                positions=jnp.asarray(pos),
                                cross_states=jnp.asarray(st), **kw)
    got, tc = TT.block_forward(tcfg, kind, tpp, _t(x), positions=_t(pos),
                               cross_states=_t(st), **kw)
    assert jc is None and tc is None
    _close(got, want)
    if kind == "enc_attn":
        # bidirectional: the first position sees the last
        y = x.copy()
        y[:, -1] = np.random.RandomState(8).randn(2, jcfg.d_model)
        moved, _ = TT.block_forward(tcfg, kind, tpp, _t(y),
                                    positions=_t(pos), **kw)
        assert (moved[:, 0] - got[:, 0]).abs().max() > 1e-4


def test_decoder_block_with_a_cache_matches_reference():
    """``dec_attn_cross`` prefill into a dense cache: the self-attention
    writes the cache, the cross-attention reads the states only; a
    ``cross`` block's cache (None) passes through."""
    for arch, kind in ((WHISPER, "dec_attn_cross"), (VLM, "cross")):
        jcfg, tcfg, jp, tp = model(arch)
        slot = jcfg.block_pattern.index(kind)
        jpp = jax.tree.map(lambda a: a[0], jp["blocks"][slot])
        tpp = tree_map(lambda a: a[0], tp["blocks"][slot])
        x = np.random.RandomState(6).randn(2, 7, jcfg.d_model) \
            .astype(np.float32)
        st = side_input(jcfg)
        jcache = JM._slot_cache(jcfg, kind, None, 2, 16)
        tcache = TM._slot_cache(tcfg, kind, None, 2, 16, "cpu")
        pos = np.arange(7)[None]
        want, jnc = JT.block_forward(
            jcfg, kind, jpp, jnp.asarray(x), positions=jnp.asarray(pos),
            cache=jcache, cache_len=jnp.zeros((), jnp.int32),
            cross_states=jnp.asarray(st))
        got, tnc = TT.block_forward(
            tcfg, kind, tpp, _t(x), positions=_t(pos), cache=tcache,
            cache_len=0, cross_states=_t(st))
        _close(got, want)
        if kind == "cross":
            assert jnc is None and tnc is None
        else:
            assert sorted(tnc) == sorted(jnc) == ["k", "v"]
            for k in ("k", "v"):
                _close(tnc[k], jnc[k])


def test_decoder_block_without_states_keeps_reference_behaviour():
    """With ``cross_states`` None the decoder's "cross" attention attends
    over its own input, with rope and a causal mask — the reference's
    behaviour, which its lock-step engine reaches (ROADMAP Queue 3)."""
    jcfg, tcfg, jp, tp = model(WHISPER)
    jpp = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    tpp = tree_map(lambda a: a[0], tp["blocks"][0])
    x = np.random.RandomState(7).randn(2, 6, jcfg.d_model).astype(np.float32)
    pos = np.arange(6)[None] + 3
    want, _ = JT.block_forward(jcfg, "dec_attn_cross", jpp, jnp.asarray(x),
                               positions=jnp.asarray(pos))
    got, _ = TT.block_forward(tcfg, "dec_attn_cross", tpp, _t(x),
                              positions=_t(pos))
    _close(got, want)


# --------------------------------------------------------------------------
# encode, forward, prefill / decode, a train step
# --------------------------------------------------------------------------

def test_encode_matches_reference():
    jcfg, tcfg, jp, tp = model(WHISPER)
    fe = side_input(jcfg)
    want = JT.encode(jcfg, jp, jnp.asarray(fe))
    got = TT.encode(tcfg, tp, _t(fe))
    assert tuple(got.shape) == (2, jcfg.frontend_tokens, jcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch, kw", [(VLM, "cross_states"),
                                      (WHISPER, "frontend_embeds"),
                                      (WHISPER, "cross_states")])
def test_forward_matches_reference(arch, kw):
    jcfg, tcfg, jp, tp = model(arch)
    tok, st = tokens(jcfg), side_input(jcfg)
    want = JM.forward(jcfg, jp, jnp.asarray(tok), **{kw: jnp.asarray(st)})
    got = TM.forward(tcfg, tp, _t(tok), **{kw: _t(st)})
    assert tuple(got.shape) == (2, 12, tcfg.vocab)
    _close(got, want)
    # the side input reaches the logits
    other = TM.forward(tcfg, tp, _t(tok), **{kw: _t(st * 0.5)})
    assert (other - got).abs().max() > 1e-3


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_prefill_then_decode_matches_reference_and_forward(arch):
    """Prefill (Whisper: from ``frontend_embeds``), then one decode step
    with the states as ``cross_states`` (Whisper: the encoder's, as
    ``tests/test_smoke_archs.py:75-80`` runs it)."""
    jcfg, tcfg, jp, tp = model(arch)
    tok, st = tokens(jcfg), side_input(jcfg)
    kw = "frontend_embeds" if jcfg.enc_layers else "cross_states"
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(tok[:, :11]), 32,
                        **{kw: jnp.asarray(st)})
    jcs = (JT.encode(jcfg, jp, jnp.asarray(st)) if jcfg.enc_layers
           else jnp.asarray(st))
    jd, _ = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok[:, 11:]),
                           cross_states=jcs)
    tl, tc = TM.prefill(tcfg, tp, _t(tok[:, :11]), 32, **{kw: _t(st)})
    tcs = TT.encode(tcfg, tp, _t(st)) if tcfg.enc_layers else _t(st)
    td, tc = TM.decode_step(tcfg, tp, tc, _t(tok[:, 11:]), cross_states=tcs)
    _close(tl, jl)
    _close(td, jd)
    assert tc["len"] == 12
    full = TM.forward(tcfg, tp, _t(tok), **{kw: _t(st)})
    _close(tl, full[:, 10])
    _close(td, full[:, 11])


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_one_train_step_matches_reference(arch):
    jcfg, tcfg, jp, tp = model(arch)
    tok, st = tokens(jcfg), side_input(jcfg)
    labels = np.roll(tok, -1, axis=1)
    kw = "frontend_embeds" if jcfg.enc_layers else "cross_states"
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=20)
    jstep = jts.build_train_step(jcfg, jopt.OptConfig(**oc), 1)
    tstep = tts.build_train_step(tcfg, opt.OptConfig(**oc), 1)
    _, _, jm = jstep(jp, jopt.init(jp),
                     {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels),
                      kw: jnp.asarray(st)})
    with torch.no_grad():            # as the engine's segments run it
        _, _, tm = tstep(tp, opt.init(tp),
                         {"tokens": _t(tok), "labels": _t(labels),
                          kw: _t(st)})
    for k in ("loss", "grad_norm"):
        _close(tm[k], jm[k])
    assert float(tm["grad_norm"]) > 0


def test_remat_encoder_matches_plain_gradients():
    """With ``cfg.remat`` the encoder's layers run under checkpointing
    while autograd records: the gradients equal those without it."""
    _, tcfg, _, tp = model(WHISPER)
    fe = _t(side_input(tcfg))
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy="full")
        params = tree_map(lambda a: a.clone().requires_grad_(True), tp)
        TT.encode(cfg, params, fe).square().mean().backward()
        grads.append(params["encoder"]["attn"]["wq"].grad)
    torch.testing.assert_close(grads[0], grads[1])
