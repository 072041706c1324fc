"""The port's sharded train step and training launcher, on the CPU.

* ``build_train_step`` of smoke llama3-8b in float32 (microbatches 2,
  4 steps, batch 8 x 32) on a (2, 2) (data, model) mesh of 4 CPU
  processes over gloo — params and optimizer state DTensors placed by
  ``parallel.specs``, the step under ``use_policy(ShardingPolicy(mesh))``
  — gives the losses and gradient norms of the port's one-process run and
  of the reference's one-device run within 1e-4 relative, and its params
  after the 4 steps equal the one-process run's within 1e-5 (the
  computation the reference's ``tests/test_multidevice.py`` builds on 8
  host devices).
* ``python -m repro_torch.launch.train --device cpu`` (smoke llama3-8b,
  float32): a checkpoint written by one process resumes on two
  (``--model-parallel 2``: a (1, 2) mesh, reshard-on-load) and back on
  one, and the losses continue an uninterrupted one-process run's within
  1e-4 relative (the printed losses carry 4 decimals).

Every rank is a process of its own (this file as a script, or the
launcher with ``RANK``/``WORLD_SIZE`` set), with ``init_method=
"file://..."`` under ``tmp_path`` and a timeout of 120 s.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
TOL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32")
STEPS, MICRO = 4, 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _wait_all(procs):
    """Outputs of ``procs``, each given TIMEOUT from now; all killed on
    the way out."""
    outs = []
    t0 = time.monotonic()
    try:
        for p in procs:
            left = max(1.0, TIMEOUT - (time.monotonic() - t0))
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _batch(vocab):
    rng = np.random.RandomState(0)
    return (rng.randint(0, vocab, (8, 32)).astype(np.int32),
            rng.randint(0, vocab, (8, 32)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the reference comparisons run with JAX on the CPU")
    return jax


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_ref):
    """The reference's one-device run, the port's one-process run and its
    (2, 2) four-process run of the same steps from the same params."""
    jax = jax_ref
    import jax.numpy as jnp
    from repro.configs import smoke_config as j_smoke
    from repro.models import model as JM
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro_torch.configs import smoke_config as t_smoke
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as tts

    tmp = tmp_path_factory.mktemp("launch")
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), **F32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    np.savez(tmp / "params.npz", *[np.asarray(x)
                                   for x in jax.tree.leaves(jp)])
    tokens, labels = _batch(jcfg.vocab)

    jstep = jax.jit(jts.build_train_step(jcfg, jopt.OptConfig(**OPT),
                                         microbatches=MICRO))
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    p, o, ref = jp, jopt.init(jp), []
    for _ in range(STEPS):
        p, o, m = jstep(p, o, jb)
        ref.append((float(m["loss"]), float(m["grad_norm"])))

    tcfg = dataclasses.replace(t_smoke("llama3-8b"), **F32)
    tstep = tts.build_train_step(tcfg, opt.OptConfig(**OPT),
                                 microbatches=MICRO)
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    o, one = opt.init(p), []
    with torch.no_grad():
        for _ in range(STEPS):
            p, o, m = tstep(p, o, tb)
            one.append((float(m["loss"]), float(m["grad_norm"])))

    env = _env()
    init = f"file://{tmp}/init"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "4", init,
         str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    outs = _wait_all(procs)
    sharded = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    return ref, one, p, sharded, tmp


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_sharded_train_step_matches_one_process(runs):
    _, one, _, sharded, _ = runs
    for r in sharded:
        assert _rel(r["metrics"], one) < TOL
    assert one[-1][0] < one[0][0]


def test_sharded_train_step_matches_reference(runs):
    ref, _, _, sharded, _ = runs
    for r in sharded:
        assert _rel(r["metrics"], ref) < TOL


def test_sharded_train_step_params_match_one_process(runs):
    from repro_torch.core.pytree import tree_leaves
    _, _, p, sharded, tmp = runs
    want = [x.numpy() for x in tree_leaves(p)]
    with np.load(tmp / "final_params.npz") as z:
        got = [z[f"arr_{i}"] for i in range(len(z))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_sharded_train_step_keeps_spec_placements(runs):
    _, _, _, sharded, _ = runs
    for r in sharded:
        assert r["placements_kept"]
        # the (2, 2) mesh shards something over each axis
        assert r["sharded_over"] == ["data", "model"]


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

LAUNCH = ["-m", "repro_torch.launch.train", "--arch", "llama3-8b",
          "--smoke", "--dtype", "float32", "--device", "cpu",
          "--log-every", "1", "--total-steps", "10"]


def _launch(ckpt, steps, world=1, init=None, extra=()):
    args = LAUNCH + ["--steps", str(steps), "--ckpt-dir", str(ckpt),
                     "--ckpt-every", str(steps), *extra]
    procs = []
    for r in range(world):
        env = _env()
        if world > 1:
            env.update(RANK=str(r), WORLD_SIZE=str(world))
            args_r = args + ["--init-method", init, "--model-parallel",
                             str(world)]
        else:
            args_r = args
        procs.append(subprocess.Popen(
            [sys.executable, *args_r], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return _wait_all(procs)


def _losses(out):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+) loss ([-\d.]+) \[", out, re.M)}


def test_launcher_resumes_one_process_checkpoint_on_two_and_back(tmp_path):
    ck = tmp_path / "ck"
    first = _launch(ck, 4)[0]
    assert "launch: arch=llama3-8b-smoke devices=1 mesh=1-device" in first
    two = _launch(ck, 4, world=2, init=f"file://{tmp_path}/init")
    for out in two:
        assert "devices=2 mesh={'data': 1, 'model': 2}" in out
        assert "auto-resumed from step 4" in out
        assert re.search(r"^done: loss [\d.]+ -> [\d.]+$", out, re.M)
        assert "terra: {" in out
    back = _launch(ck, 2)[0]
    assert "auto-resumed from step 8" in back
    whole = _losses(_launch(tmp_path / "whole", 10)[0])
    got = {**_losses(first), **_losses(two[0]), **_losses(back)}
    assert _losses(two[1]) == _losses(two[0])
    assert sorted(got) == sorted(whole) == list(range(1, 11))
    assert _rel([got[s] for s in range(1, 11)],
                [whole[s] for s in range(1, 11)]) < TOL
    assert whole[10] < whole[1]


# --------------------------------------------------------------------------
# the rank processes of the sharded train step (this file as a script)
# --------------------------------------------------------------------------

def _rank_main(rank, world, init, out_dir):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.configs import smoke_config
    from repro_torch.core.pytree import tree_flatten, tree_leaves, \
        tree_map, tree_unflatten
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import model as TM
    from repro_torch.parallel import specs
    from repro_torch.parallel.sharding import ShardingPolicy, use_policy
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import build_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    mesh = make_mesh_for({"data": 2, "model": 2})
    cfg = dataclasses.replace(smoke_config("llama3-8b"), **F32)
    leaves, treedef = tree_flatten(TM.init_params(cfg, device="meta"))
    with np.load(os.path.join(out_dir, "params.npz")) as z:
        params = tree_unflatten(treedef, [torch.from_numpy(z[f"arr_{i}"])
                                          for i in range(len(z))])
    p_sh = specs.tree_shardings(mesh, params)
    o_sh = specs.opt_state_shardings(mesh, p_sh)
    params = tree_map(specs.distribute, params, p_sh)
    ost = tree_map(specs.distribute, opt.init(tree_map(
        lambda x: x.full_tensor(), params)), o_sh)
    step = build_train_step(cfg, opt.OptConfig(**OPT), microbatches=MICRO)
    tokens, labels = _batch(cfg.vocab)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    metrics = []
    with use_policy(ShardingPolicy(mesh)), torch.no_grad():
        for _ in range(STEPS):
            params, ost, m = step(params, ost, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    kept = all(
        isinstance(x, DTensor) and x.placements == sh.placements
        for x, sh in zip(tree_leaves(params) + tree_leaves(ost),
                         tree_leaves(p_sh) + tree_leaves(o_sh)))
    over = sorted({mesh.mesh_dim_names[i] for x in tree_leaves(params)
                   for i, pl in enumerate(x.placements)
                   if isinstance(pl, Shard)})
    full = [x.full_tensor().numpy() for x in tree_leaves(params)]
    if rank == 0:
        np.savez(os.path.join(out_dir, "final_params.npz"), *full)
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "metrics": metrics,
                      "placements_kept": kept, "sharded_over": over}))


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
