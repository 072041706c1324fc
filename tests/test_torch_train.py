"""The port's training stack (``repro_torch.train``, ``parallel.sharding``
and the remat transformer) against the JAX reference.

The ``tests/test_substrate.py`` optimizer, schedule, data and checkpoint
tests are ported; AdamW, the loss and its gradients, the train step and
the ``Trainer`` are held against the reference on numpy-seeded inputs and
identical starting state (f32: rtol 1e-4, atol 1e-5, unless a test says
why it needs more).  Checkpoints cross between the packages both ways,
bit-equal in bfloat16.  The port runs with ``device="cpu"``.
"""

import dataclasses
import importlib.util
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import reference_view  # noqa: E402
from repro_torch.core.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import data as data_mod  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
F32 = dict(dtype="float32", param_dtype="float32")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------
# optimizer (tests/test_substrate.py, ported) and against the reference
# --------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    oc = opt.OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                       weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    state = opt.init(params)
    for _ in range(50):
        grads = {"w": 2 * params["w"]}        # d/dw ||w||^2
        params, state, m = opt.apply(oc, state, grads, params)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_bf16_params_keep_f32_master():
    oc = opt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["master"]["w"].dtype == torch.float32
    params2, state2, _ = opt.apply(
        oc, state, {"w": torch.ones(4, dtype=torch.bfloat16)}, params)
    assert params2["w"].dtype == torch.bfloat16
    assert state2["master"]["w"].dtype == torch.float32


def test_grad_clipping_bounds_update():
    oc = opt.OptConfig(lr=1.0, warmup_steps=0, total_steps=10,
                       clip_norm=1e-3, weight_decay=0.0)
    params = {"w": torch.zeros(2)}
    state = opt.init(params)
    _, _, m = opt.apply(oc, state, {"w": torch.full((2,), 1e6)}, params)
    assert float(m["grad_norm"]) > 1e5       # raw norm reported


@pytest.mark.parametrize("step", [0, 1, 99, 100, 1000, 2 ** 31 - 1] + [
    int(s) for s in np.random.RandomState(0).randint(0, 2 ** 31 - 1, 14)])
def test_schedule_monotone_warmup_and_bounded(step):
    oc = opt.OptConfig(lr=3e-4, warmup_steps=100, total_steps=1000)
    lr = float(opt.schedule(oc, torch.tensor(step, dtype=torch.float32)))
    assert 0.0 <= lr <= oc.lr + 1e-9


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 550, 1000, 5000])
def test_schedule_matches_reference(step):
    oc = dict(lr=3e-4, warmup_steps=100, total_steps=1000)
    _close(opt.schedule(opt.OptConfig(**oc), step),
           jopt.schedule(jopt.OptConfig(**oc), step), rtol=1e-6, atol=1e-12)


def test_adamw_matches_reference_over_steps():
    """Three AdamW updates (warmup, clipping, weight decay) of a small tree
    from the same numpy values: params, moments, master and metrics."""
    r = np.random.RandomState(0)
    p0 = {"a": r.randn(3, 4).astype(np.float32),
          "b": [r.randn(5).astype(np.float32)]}
    gs = [{"a": r.randn(3, 4).astype(np.float32) * 3,
           "b": [r.randn(5).astype(np.float32)]} for _ in range(3)]
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=2.0)
    jp, tp = jax.tree.map(jnp.asarray, p0), tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), opt.init(tp)
    for g in gs:
        jp, js, jm = jopt.apply(jopt.OptConfig(**oc), js,
                                jax.tree.map(jnp.asarray, g), jp)
        tp, ts, tm = opt.apply(opt.OptConfig(**oc), ts,
                               tree_map(torch.from_numpy, g), tp)
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k])
    for t, j in zip(tree_leaves({"p": tp, "s": ts}),
                    jax.tree.leaves({"p": jp, "s": js})):
        _close(t, j)
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32


# --------------------------------------------------------------------------
# data pipeline (tests/test_substrate.py, ported) and against the reference
# --------------------------------------------------------------------------

def test_data_deterministic_and_resumable():
    ds = data_mod.SyntheticLMDataset(vocab=100, seq_len=8, batch=2, seed=3)
    a = ds.batch_at(5)
    b = ds.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    it = data_mod.PrefetchIterator(ds, start_step=0)
    next(it)
    it.seek(5)
    resumed = next(it)
    np.testing.assert_array_equal(resumed["tokens"], a["tokens"])
    it.close()


def test_data_shards_differ():
    d0 = data_mod.SyntheticLMDataset(100, 8, 2, seed=3, shard=0, n_shards=2)
    d1 = data_mod.SyntheticLMDataset(100, 8, 2, seed=3, shard=1, n_shards=2)
    assert not np.array_equal(d0.batch_at(0)["tokens"],
                              d1.batch_at(0)["tokens"])


def test_data_batches_equal_the_reference():
    kw = dict(vocab=300, seq_len=16, batch=3, seed=7,
              extras={"frames": {"shape": (4, 2)}})
    t, j = data_mod.SyntheticLMDataset(**kw), jdata.SyntheticLMDataset(**kw)
    for s in (0, 1, 17):
        a, b = t.batch_at(s), j.batch_at(s)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# checkpoint (tests/test_substrate.py, ported) and across the packages
# --------------------------------------------------------------------------

def _tree(pkg_torch):
    a = np.arange(6, dtype=np.float32).reshape(2, 3) / 7.0
    if pkg_torch:
        return {"a": torch.from_numpy(a).to(torch.bfloat16),
                "b": {"c": torch.ones(3), "d": torch.zeros((), dtype=torch.int32)},
                "l": [torch.full((2,), 0.3), None]}
    return {"a": jnp.asarray(a).astype(jnp.bfloat16),
            "b": {"c": jnp.ones((3,), jnp.float32),
                  "d": jnp.zeros((), jnp.int32)},
            "l": [jnp.full((2,), 0.3, jnp.float32), None]}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if str(x.dtype) == "bfloat16" else x


def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = _tree(True)
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore(str(tmp_path), 7, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_crash_safety_keeps_previous(tmp_path):
    tree = {"a": torch.ones(2)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree_map(lambda x: x * 2, tree))
    assert ckpt.latest_step(str(tmp_path)) == 2
    # step_1 still restorable (atomic commits never corrupt old state)
    out = ckpt.restore(str(tmp_path), 1, tree)
    np.testing.assert_array_equal(out["a"].numpy(), [1.0, 1.0])


def test_checkpoint_async_save_commits(tmp_path):
    t = ckpt.save(str(tmp_path), 3, _tree(True), blocking=False)
    t.join()
    assert ckpt.latest_step(str(tmp_path)) == 3
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 3, {"zz": torch.ones(1)})
    # reshard-on-load takes NamedShardings (a tree of them, or one); the
    # mesh path runs in tests/test_torch_launch.py
    with pytest.raises(TypeError, match="NamedSharding"):
        ckpt.restore(str(tmp_path), 3, _tree(True), shardings=object())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages_bit_equal(writer, tmp_path):
    """A checkpoint written by either package restores in the other: same
    keys, files and manifest, bf16 bit for bit."""
    jt, tt = _tree(False), _tree(True)
    d = str(tmp_path)
    if writer == "reference":
        jckpt.save(d, 4, jt)
        out, want = ckpt.restore(d, 4, tt), jt
        leaves = tree_leaves(out)
    else:
        ckpt.save(d, 4, tt)
        out, want = jckpt.restore(d, 4, jt), tt
        leaves = jax.tree.leaves(out)
    ref_leaves = (jax.tree.leaves(want) if writer == "reference"
                  else tree_leaves(want))
    assert len(leaves) == len(ref_leaves) == 4
    for a, b in zip(leaves, ref_leaves):
        assert str(a.dtype).replace("torch.", "") == \
            str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 4


# --------------------------------------------------------------------------
# sharding policy: the single-device part
# --------------------------------------------------------------------------

def test_sharding_policy_is_the_identity_on_one_device():
    x = torch.ones(2, 3)
    assert sharding.logical(x, "batch", None) is x
    pol = sharding.ShardingPolicy(None)
    with sharding.use_policy(pol):
        assert sharding.current_policy() is pol
        assert sharding.logical(x, "batch", None) is x
    assert sharding.current_policy() is None
    from repro.parallel.sharding import DEFAULT_RULES
    assert sharding.DEFAULT_RULES == DEFAULT_RULES
    # a mesh is a DeviceMesh with axis names (the mesh path runs in
    # tests/test_torch_launch.py and tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="mesh_dim_names"):
        sharding.ShardingPolicy(mesh=object())


# --------------------------------------------------------------------------
# loss, gradients and the train step against the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), **F32)
    tcfg = dataclasses.replace(t_smoke("llama3-8b"), **F32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    r = np.random.RandomState(1)
    tok = r.randint(0, jcfg.vocab, (2, 16)).astype(np.int32)
    lab = r.randint(0, jcfg.vocab, (2, 16)).astype(np.int32)
    return jcfg, tcfg, jp, tp, tok, lab


@pytest.mark.parametrize("remat", ["off", "full", "dots"])
def test_lm_loss_and_grads_match_reference(llama, remat):
    jcfg, tcfg, jp, tp, tok, lab = llama
    if remat != "off":
        jcfg = dataclasses.replace(jcfg, remat=True, remat_policy=remat)
        tcfg = dataclasses.replace(tcfg, remat=True, remat_policy=remat)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jts.lm_loss(jcfg, p, tok, lab), has_aux=True)(jp)
    leaves = tree_leaves(tp)
    xs = [p.clone().requires_grad_(True) for p in leaves]
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    _, td = tree_flatten(tp)
    tl, taux = tts.lm_loss(tcfg, tree_unflatten(td, xs),
                           torch.from_numpy(tok), torch.from_numpy(lab))
    tg = torch.autograd.grad(tl, xs)
    _close(tl, jl)
    _close(taux["nll"], jaux["nll"])
    jleaves = jax.tree.leaves(jg)
    assert len(tg) == len(jleaves)
    for t, j in zip(tg, jleaves):
        _close(t, j)


def test_remat_attn_out_policy_raises_until_ported(llama):
    """(Name kept from when the policy raised.)  ``"attn_out"`` is ported:
    the loss and gradients equal the reference's with the same policy,
    and eval (no autograd) runs it unrematerialized with the same loss."""
    jcfg, tcfg, jp, tp, tok, lab = llama
    jcfg = dataclasses.replace(jcfg, remat=True, remat_policy="attn_out")
    cfg = dataclasses.replace(tcfg, remat=True, remat_policy="attn_out")
    (jl, _), jg = jax.value_and_grad(
        lambda p: jts.lm_loss(jcfg, p, tok, lab), has_aux=True)(jp)
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    leaves, td = tree_flatten(tp)
    xs = [p.clone().requires_grad_(True) for p in leaves]
    tl, _ = tts.lm_loss(cfg, tree_unflatten(td, xs), torch.from_numpy(tok),
                        torch.from_numpy(lab))
    _close(tl, jl)
    for t, j in zip(torch.autograd.grad(tl, xs), jax.tree.leaves(jg)):
        _close(t, j)
    with torch.no_grad():                      # eval never rematerializes
        el, _ = tts.lm_loss(cfg, tp, torch.from_numpy(tok),
                            torch.from_numpy(lab))
    _close(el, jl)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_and_eval_step_match_reference(llama, microbatches):
    jcfg, tcfg, jp, tp, tok, lab = llama
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=20)
    jstep = jts.build_train_step(jcfg, jopt.OptConfig(**oc), microbatches)
    tstep = tts.build_train_step(tcfg, opt.OptConfig(**oc), microbatches)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    jnp_, jst, jm = jstep(jp, jopt.init(jp), jb)
    with torch.no_grad():            # as the engine's segments run it
        tnp, tst, tm = tstep(tp, opt.init(tp), tb)
    for k in ("loss", "grad_norm", "lr"):
        _close(tm[k], jm[k])
    for t, j in zip(tree_leaves({"p": tnp, "s": tst}),
                    jax.tree.leaves({"p": jnp_, "s": jst})):
        _close(t, j)
    je = jts.eval_step(jcfg, jp, jb)
    te = tts.eval_step(tcfg, tp, tb)
    _close(te["loss"], je["loss"])
    _close(te["nll"], je["nll"])


# --------------------------------------------------------------------------
# the Trainer against the reference's
# --------------------------------------------------------------------------

def _start_from_reference(jcfg, root, names):
    """A step-0 checkpoint of the reference Trainer (its initial params
    and optimizer state), copied into one directory per name: each
    Trainer resumes from its own copy, so all start from the same state."""
    dirs = [os.path.join(root, n) for n in names]
    JTrainer(jcfg, jopt.OptConfig(**OPT), ckpt_dir=dirs[0], batch=2,
             seq_len=16).train(0, verbose=False)
    for d in dirs[1:]:
        shutil.copytree(dirs[0], d)
    return dirs


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m"])
def test_trainer_losses_match_reference_and_resume(arch, tmp_path):
    jcfg = dataclasses.replace(j_smoke(arch), **F32)
    tcfg = dataclasses.replace(t_smoke(arch), **F32)
    ref, port, straight = _start_from_reference(
        jcfg, str(tmp_path), ["ref", "port", "straight"])
    kw = dict(batch=2, seq_len=16, log_every=1, ckpt_every=4)

    jt = JTrainer(jcfg, jopt.OptConfig(**OPT), ckpt_dir=ref, **kw)
    want = [l for _, l in jt.train(8, verbose=False)]
    jt._iteration.close()
    tt = Trainer(tcfg, opt.OptConfig(**OPT), ckpt_dir=port, device="cpu",
                 **kw)
    assert tt.start_step == 0
    hist = tt.train(8, verbose=False)
    tt._iteration.close()
    assert [s for s, _ in hist] == list(range(1, 9))
    assert tt._iteration.phase == "co-execution"
    _close([l for _, l in hist], want)

    # resume: the port's checkpoint at step 8 holds the trained state, so
    # four more steps continue the run exactly as an uninterrupted one
    t2 = Trainer(tcfg, opt.OptConfig(**OPT), ckpt_dir=port, device="cpu",
                 **kw)
    assert t2.start_step == 8
    resumed = t2.train(4, verbose=False)
    t2._iteration.close()
    t3 = Trainer(tcfg, opt.OptConfig(**OPT), ckpt_dir=straight,
                 device="cpu", **kw)
    t3.ckpt_dir = None
    full = t3.train(12, verbose=False)
    t3._iteration.close()
    assert [s for s, _ in resumed] == list(range(9, 13))
    _close([l for _, l in resumed], [l for _, l in full[8:]])


def test_trainer_eager_matches_coexecution(tmp_path):
    cfg = dataclasses.replace(t_smoke("llama3-8b"), **F32)
    kw = dict(batch=2, seq_len=16, log_every=1, seed=3, device="cpu")
    terra = Trainer(cfg, opt.OptConfig(**OPT), **kw)
    eager = Trainer(cfg, opt.OptConfig(**OPT), use_terra=False, **kw)
    a = terra.train(6, verbose=False)
    b = eager.train(6, verbose=False)
    terra._iteration.close()
    _close([l for _, l in a], [l for _, l in b], rtol=1e-6, atol=1e-6)
    for x, y in zip(tree_leaves(terra.state_tree()),
                    tree_leaves(eager.state_tree())):
        _close(x, y, rtol=1e-6, atol=1e-6)


def test_trainer_straggler_watchdog_fields():
    """tests/test_system.py's watchdog check, on the mamba2 smoke trainer
    (which trains on the CPU: the SSD kernel has no backward)."""
    cfg = t_smoke("mamba2-130m")
    tr = Trainer(cfg, opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50),
                 batch=2, seq_len=32, log_every=50, device="cpu")
    tr.train(12, verbose=False)
    assert isinstance(tr.straggler_events, list)   # watchdog active
    assert tr._iteration.phase == "co-execution"
    tr._iteration.close()


def test_trainer_microbatches_and_bf16_train(tmp_path):
    """The default bf16 params with gradient accumulation: finite, falling
    loss, f32 master weights, bf16 checkpoint leaves."""
    cfg = t_smoke("llama3-8b")
    tr = Trainer(cfg, opt.OptConfig(lr=3e-3, warmup_steps=2, total_steps=40),
                 ckpt_dir=str(tmp_path), batch=4, seq_len=16, microbatches=2,
                 log_every=1, device="cpu")
    hist = tr.train(12, verbose=False)
    tr._iteration.close()
    losses = [l for _, l in hist]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    tree = tr.state_tree()
    assert tree["params"]["embed"].dtype == torch.bfloat16
    assert tree["opt"]["master"]["embed"].dtype == torch.float32
    # the reference restores the port's bf16 checkpoint bit for bit
    jp = JM.init_params(j_smoke("llama3-8b"), jax.random.PRNGKey(0))
    out = jckpt.restore(str(tmp_path), 12, {"params": jp,
                                            "opt": jopt.init(jp)})
    for a, b in zip(jax.tree.leaves(out), tree_leaves(tree)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# --------------------------------------------------------------------------
# the accelerator-scale preset: chip_smoke.py's copy and the port example
# --------------------------------------------------------------------------

def test_100m_preset_copies_equal_train_lm():
    ref = _load(os.path.join(ROOT, "examples", "train_lm.py"),
                "train_lm_ref")
    port = _load(os.path.join(ROOT, "examples", "train_lm_torch.py"),
                 "train_lm_port")
    smoke = _load(os.path.join(ROOT, "chip_smoke.py"), "chip_smoke_copy")
    want = ref.PRESETS["100m"]
    copy = smoke.TRAIN_100M
    assert reference_view(ModelConfig(**copy["cfg"])) == \
        dataclasses.asdict(want["cfg"])
    assert (copy["batch"], copy["seq_len"]) == (want["batch"],
                                                 want["seq_len"])
    for name, p in ref.PRESETS.items():
        q = port.PRESETS[name]
        assert reference_view(q["cfg"]) == dataclasses.asdict(p["cfg"])
        assert (q["batch"], q["seq_len"]) == (p["batch"], p["seq_len"])


def test_train_lm_torch_example_runs_on_the_cpu(tmp_path, monkeypatch,
                                                 capsys):
    ex = _load(os.path.join(ROOT, "examples", "train_lm_torch.py"),
               "train_lm_port_main")
    monkeypatch.setattr("sys.argv", [
        "train_lm_torch.py", "--preset", "tiny", "--steps", "10",
        "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    ex.main()
    out = capsys.readouterr().out
    assert "device=cpu" in out and "final loss" in out
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_a_closed_trainer_is_freed():
    """The train step op stays in the op registry (``def_op``) after its
    trainer is gone, so its closure must not hold the trainer: once
    closed and dropped, the trainer and its state are collectable (on the
    card the captured trainer's state would otherwise stay resident)."""
    import gc
    import weakref
    tcfg = dataclasses.replace(t_smoke("llama3-8b"), **F32)
    tr = Trainer(tcfg, opt.OptConfig(**OPT), batch=2, seq_len=8,
                 log_every=1, device="cpu")
    tr.train(3, verbose=False)
    tr._iteration.close()
    ref = weakref.ref(tr)
    del tr
    gc.collect()
    assert ref() is None
