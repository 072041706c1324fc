"""The port's model families against the JAX reference, on the CPU.

The six decoder architectures this slice adds to the port's registry
(three dense, two MoE, one hybrid RG-LRU / local attention), at their
smoke widths in float32, with the reference's parameters converted by
``params_from_jax`` and numpy-seeded tokens.  For each: the forward
logits; prefill then one decode step, against the reference's and
against the port's own forward (``tests/test_smoke_archs.py``'s
consistency check, held to 1e-4 here since both run in f32); and one
AdamW train step's loss and gradient norm.  Tolerance 1e-4 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import reference_view  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

TOL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32")
NEW_ARCHS = ["codeqwen1.5-7b", "deepseek-moe-16b", "granite-3-2b",
             "mixtral-8x22b", "qwen2.5-14b", "recurrentgemma-2b"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch(request):
    name = request.param
    jcfg = dataclasses.replace(j_smoke(name), **F32)
    tcfg = dataclasses.replace(t_smoke(name), **F32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    return name, jcfg, tcfg, jp, tp, tokens


def _close(got, want, tol=TOL):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(g, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_registry_carries_the_decoder_archs():
    """The registry is the reference's ten: the decoder archs, and since
    the cross-attention slice whisper-small and llama-3.2-vision-90b,
    each config and smoke config equal to the reference's."""
    from repro.configs import get_config as jg
    from repro.configs.registry import ARCHS as J_ARCHS
    assert sorted(ARCHS) == sorted(
        ["llama3-8b", "mamba2-130m"] + NEW_ARCHS
        + ["whisper-small", "llama-3.2-vision-90b"]) == sorted(J_ARCHS)
    for name in ARCHS:
        # the reference's fields equal, each port-only field at its
        # default (reference_view raises otherwise)
        assert reference_view(get_config(name)) == \
            dataclasses.asdict(jg(name))
        assert reference_view(t_smoke(name)) == \
            dataclasses.asdict(j_smoke(name))
    assert get_config("whisper-small").enc_layers == 12
    assert "cross" in get_config("llama-3.2-vision-90b").block_pattern


def test_forward_matches_reference(arch):
    _, jcfg, tcfg, jp, tp, tokens = arch
    want = JM.forward(jcfg, jp, jnp.asarray(tokens))
    got = TM.forward(tcfg, tp, torch.from_numpy(tokens))
    assert tuple(got.shape) == (2, 16, tcfg.vocab)
    _close(got, want)


def test_prefill_then_decode_matches_reference_and_forward(arch):
    _, jcfg, tcfg, jp, tp, tokens = arch
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(tokens[:, :15]), max_len=32)
    jd, _ = JM.decode_step(jcfg, jp, jc, jnp.asarray(tokens[:, 15:16]))
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(tokens[:, :15]), 32)
    td, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tokens[:, 15:16]))
    _close(tl, jl)
    _close(td, jd)
    assert tc["len"] == 16
    full = TM.forward(tcfg, tp, torch.from_numpy(tokens))
    _close(tl, full[:, 14])
    _close(td, full[:, 15])


def test_one_train_step_matches_reference(arch):
    _, jcfg, tcfg, jp, tp, tokens = arch
    labels = np.roll(tokens, -1, axis=1)
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=20)
    jstep = jts.build_train_step(jcfg, jopt.OptConfig(**oc), 1)
    tstep = tts.build_train_step(tcfg, opt.OptConfig(**oc), 1)
    _, _, jm = jstep(jp, jopt.init(jp),
                     {"tokens": jnp.asarray(tokens),
                      "labels": jnp.asarray(labels)})
    with torch.no_grad():            # as the engine's segments run it
        _, _, tm = tstep(tp, opt.init(tp),
                         {"tokens": torch.from_numpy(tokens),
                          "labels": torch.from_numpy(labels)})
    for k in ("loss", "grad_norm"):
        _close(tm[k], jm[k])
    assert float(tm["grad_norm"]) > 0


@pytest.mark.parametrize("policy", ["full", "dots", "attn_out"])
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "recurrentgemma-2b"])
def test_remat_keeps_moe_and_rglru_gradients(name, policy):
    """Remat over moe and rglru super-blocks (torch.utils.checkpoint, as
    on attn blocks) gives the gradients of the plain run."""
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    tcfg = dataclasses.replace(t_smoke(name), **F32)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, tcfg.vocab, (2, 12)).astype(np.int32))
    labels = torch.roll(tokens, -1, 1)
    leaves, td = tree_flatten(params)
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        xs = [t.clone().requires_grad_(t.is_floating_point()) for t in leaves]
        loss, _ = tts.lm_loss(cfg, tree_unflatten(td, xs), tokens, labels)
        grads[remat] = torch.autograd.grad(
            loss, [x for x in xs if x.requires_grad])
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-moe-16b",
                                  "recurrentgemma-2b"])
def test_attn_out_remat_matches_reference(name):
    """Remat policy ``"attn_out"`` (two checkpoint regions per attention
    block: the attention output kept, the FFN recomputed) against the
    reference's ``save_only_these_names("attn_out")``: the loss within
    TOL relative and every gradient within TOL of its leaf's largest."""
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    kw = dict(remat=True, remat_policy="attn_out", **F32)
    jcfg = dataclasses.replace(j_smoke(name), **kw)
    tcfg = dataclasses.replace(t_smoke(name), **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(4).randint(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jts.lm_loss(jcfg, p, jnp.asarray(tokens),
                              jnp.asarray(labels)), has_aux=True)(jp)
    leaves, td = tree_flatten(params_from_jax(jax.tree.map(np.asarray, jp),
                                              "cpu"))
    xs = [t.requires_grad_(True) for t in leaves]
    loss, _ = tts.lm_loss(tcfg, tree_unflatten(td, xs),
                          torch.from_numpy(tokens), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, xs)
    _close(loss, jl)
    want = [np.asarray(g) for g in jax.tree.leaves(jg)]
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g.numpy() - w).max() <= TOL * scale
