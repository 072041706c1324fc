"""The port's parallel layer against the JAX reference, on the CPU.

* Spec trees: ``repro_torch.parallel.specs.tree_param_specs`` equals the
  reference's, entry for entry, for every arch of the registry at its
  published size on the (16, 16) and (2, 16, 16) production meshes (an
  abstract mesh on each side: the reference's ``AbstractMesh`` and the
  port's ``launch.mesh.make_production_mesh``), with the batch and cache
  specs.
* Codecs: the bf16 and int8 gradient codecs and ``wire_bytes_saved``
  equal the reference's (bf16 exactly; int8 values and scales within
  f32 rounding).
* Collectives, on 4 CPU processes over gloo (this file run as a script,
  one process per rank, ``init_method="file://..."`` under ``tmp_path``,
  120 s each): ``dp_allreduce`` returns the mean of the ranks' gradients
  (uncompressed within 1e-6, bf16 within 1e-2 of the largest value as the
  reference's own test) and error-feedback residuals, and both packages'
  ``dp_allreduce`` raise ``ValueError`` for "int8";
  GPipe over 4 stages and 8 microbatches (d 32) equals the sequential
  loop within 1e-5; ``moe_impl="shard_map"`` on a (1, 4) mesh equals the
  port's ``moe_block`` path exactly (bf16 and f32: the all-to-alls move
  rows and reorder no sum) and the reference's one-device ``M.forward``
  within 1e-4 in f32 (smoke deepseek-moe-16b, 8 experts, top-2,
  capacity 8.0).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 120
MOE = dict(n_experts=8, top_k=2, capacity_factor=8.0)
F32 = dict(dtype="float32", param_dtype="float32")
S_STAGES, M_MICRO, MB, D = 4, 8, 4, 32


def run_ranks(tmp_path, world, *args):
    """This file as a script, one process per rank; each has its own
    TIMEOUT.  Returns their outputs."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    init = f"file://{tmp_path}/init"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), init,
         str(tmp_path), *args], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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


# --------------------------------------------------------------------------
# spec trees
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the reference comparisons run with JAX on the CPU")
    return jax


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _arch_names():
    from repro_torch.configs.registry import ARCHS
    return sorted(ARCHS)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", _arch_names())
def test_param_spec_trees_match_reference(arch, mesh, jax_ref):
    jax = jax_ref
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as j_get
    from repro.models import model as JM
    from repro.parallel import specs as JS
    from repro_torch.configs import get_config as t_get
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as TM
    from repro_torch.parallel import specs as TS

    shape = MESHES[mesh]
    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    tmesh = make_production_mesh(multi_pod="pod" in shape)
    assert tmesh.shape == shape
    jp = jax.eval_shape(lambda: JM.init_params(j_get(arch),
                                               jax.random.PRNGKey(0)))
    tp = TM.init_params(t_get(arch), device="meta")
    want = jax.tree.leaves(
        JS.tree_param_specs(jmesh, jp),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = tree_leaves(TS.tree_param_specs(tmesh, tp))
    assert len(got) == len(want) == len(tree_leaves(tp))
    assert [tuple(g) for g in got] == [tuple(w) for w in want]
    assert all(isinstance(g, TS.PartitionSpec) for g in got)
    # serve mode (no fsdp) too
    want = jax.tree.leaves(
        JS.tree_param_specs(jmesh, jp, fsdp=False),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = tree_leaves(TS.tree_param_specs(tmesh, tp, fsdp=False))
    assert [tuple(g) for g in got] == [tuple(w) for w in want]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_match_reference(mesh, jax_ref):
    from jax.sharding import AbstractMesh
    from repro.parallel import specs as JS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import specs as TS
    shape = MESHES[mesh]
    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    tmesh = make_production_mesh(multi_pod="pod" in shape)
    for s in [(256, 4096), (8, 128), (64,), (3, 5, 7)]:
        assert tuple(TS.batch_spec(tmesh, s)) == tuple(JS.batch_spec(jmesh,
                                                                     s))
    cases = [("k", (32, 128, 32768, 8, 128)), ("v", (4, 2, 6, 8, 128)),
             ("k", (128, 32768, 8, 128)), ("len", (128,)),
             ("conv", (24, 128, 3, 1792)), ("ssm", (24, 128, 24, 64, 128)),
             ("h", (128, 2560)), ("h", (3,))]
    for name, s in cases:
        assert tuple(TS.cache_spec_for(tmesh, f"layers|0|{name}", s)) \
            == tuple(JS.cache_spec_for(jmesh, f"layers|0|{name}", s))
    assert TS.batch_axes(tmesh) == JS.batch_axes(jmesh)


class _NamedMesh:
    """A DeviceMesh's names and shape, without processes: what the
    policy's spec rules read."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self.mesh = torch.empty(tuple(shape.values()), device="meta")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharding_policy_resolves_like_reference(mesh, jax_ref):
    from jax.sharding import AbstractMesh
    from repro.parallel import sharding as JSH
    from repro_torch.parallel import sharding as TSH
    from repro_torch.parallel.specs import NamedSharding
    shape = MESHES[mesh]
    jp = JSH.ShardingPolicy(AbstractMesh(tuple(shape.values()),
                                         tuple(shape)))
    tp = TSH.ShardingPolicy(_NamedMesh(shape))
    names = sorted(TSH.DEFAULT_RULES) + [None, "no-such-rule"]
    for a in names:
        for b in names:
            assert tuple(tp.spec(a, b)) == tuple(jp.spec(a, b)), (a, b)
    sh = tp.sharding("batch", None, "vocab")
    assert isinstance(sh, NamedSharding) and tuple(sh.spec) == tuple(
        jp.spec("batch", None, "vocab"))
    for shp, logical in [((64, 4096), ("fsdp", "tp")),
                         ((8, 6), ("batch", "vocab")),
                         ((48, 128, 7), ("expert", None, "d_ff"))]:
        assert tuple(TSH.param_spec(shp, logical, tp)) == tuple(
            JSH.param_spec(shp, logical, jp))
    assert TSH.ShardingPolicy(None).sharding("batch") is None


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel import specs as TS

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    P = TS.PartitionSpec
    assert TS.placements(Mesh, P("model", "data")) == (
        Replicate(), Shard(1), Shard(0))
    assert TS.placements(Mesh, P(("pod", "data"), None)) == (
        Shard(0), Shard(0), Replicate())
    assert TS.placements(Mesh, P()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        TS.placements(Mesh, P(("data", "pod")))
    with pytest.raises(ValueError):
        TS.placements(Mesh, P("model", "model"))


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64), (1000,), (3, 7, 11)])
def test_codecs_match_reference(shape, jax_ref):
    import jax.numpy as jnp
    from repro.parallel import compression as JC
    from repro_torch.parallel import compression as TC
    g = np.random.RandomState(3).randn(*shape).astype(np.float32)
    tg = torch.from_numpy(g)
    jb = np.asarray(JC.decompress_bf16(JC.compress_bf16(jnp.asarray(g))))
    tb = TC.decompress_bf16(TC.compress_bf16(tg)).numpy()
    np.testing.assert_array_equal(tb, jb)
    jq, js, jshape, jpad = JC.compress_int8(jnp.asarray(g))
    tq, ts, tshape, tpad = TC.compress_int8(tg)
    assert (tshape, tpad) == (tuple(jshape), jpad)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    # a value on a rounding boundary may round the other way when the
    # scales differ in the last bit
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)
                  ).max() <= 1
    jd = np.asarray(JC.decompress_int8((jq, js, jshape, jpad)))
    td = TC.decompress_int8((tq, ts, tshape, tpad)).numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-5,
                               atol=float(np.asarray(js).max()) * 1.001)
    assert np.abs(td - g).max() <= np.abs(g).max() / 127.0
    for c in ("none", "bf16", "int8"):
        assert TC.wire_bytes_saved({"w": tg}, c) == \
            JC.wire_bytes_saved({"w": jnp.asarray(g)}, c)


# --------------------------------------------------------------------------
# collectives on 4 gloo processes
# --------------------------------------------------------------------------

def _dp_grads():
    return np.random.RandomState(1).randn(WORLD, 64).astype(np.float32)


def _pipe_inputs():
    rng = np.random.RandomState(0)
    ws = (rng.randn(S_STAGES, D, D) * 0.2).astype(np.float32)
    xs = rng.randn(M_MICRO, MB, D).astype(np.float32)
    return ws, xs


def _moe_tokens(vocab):
    return np.random.RandomState(0).randint(0, vocab, (4, 32)).astype(
        np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_ref):
    """One 4-process run of every collective job; per rank a .npz of
    results.  The MoE params come from the reference (f32), as numpy
    leaves in flatten order."""
    jax = jax_ref
    from repro.configs import smoke_config as j_smoke
    from repro.models import model as JM
    tmp = tmp_path_factory.mktemp("parallel")
    jcfg = dataclasses.replace(j_smoke("deepseek-moe-16b"), **MOE, **F32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    leaves = [np.asarray(x) for x in jax.tree.leaves(jp)]
    np.savez(tmp / "moe_params.npz", *leaves)
    tokens = _moe_tokens(jcfg.vocab)
    ref = np.asarray(JM.forward(jcfg, jp, jax.numpy.asarray(tokens)))
    run_ranks(tmp, WORLD)
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            ref)


@pytest.mark.parametrize("compression", ["none", "bf16", "int8"])
def test_dp_allreduce_matches_mean(compression, ranks, jax_ref):
    from repro_torch.parallel import compression as TC
    if compression == "int8":
        # both packages all-reduce "none" and "bf16" only
        from repro.parallel import compression as JC
        jnp = jax_ref.numpy
        g = {"w": jnp.ones((4, 8), jnp.float32)}
        jmesh = jax_ref.sharding.Mesh(np.array(jax_ref.devices()[:1]),
                                      ("data",))
        with pytest.raises(ValueError):
            JC.dp_allreduce(jmesh, "data", "int8")(g, JC.zero_residuals(g))
        with pytest.raises(ValueError):
            TC.dp_allreduce(None, "data", "int8")
        return
    outs, _ = ranks
    g = _dp_grads()
    want = g.mean(0)
    tol = {"none": 1e-6, "bf16": 1e-2, "int8": 2e-2}[compression]
    for r, out in enumerate(outs):
        got = out[f"dp_{compression}_mean"]
        assert np.abs(got - want).max() / np.abs(want).max() < tol
        np.testing.assert_array_equal(got, outs[0][f"dp_{compression}_mean"])
        # error feedback: the residual is what the codec lost
        gr = torch.from_numpy(g[r])
        lost = {"none": torch.zeros_like(gr),
                "bf16": gr - TC.decompress_bf16(TC.compress_bf16(gr)),
                "int8": gr - TC.decompress_int8(TC.compress_int8(gr))}
        np.testing.assert_allclose(out[f"dp_{compression}_resid"],
                                   lost[compression].numpy(), atol=1e-7)


def test_gpipe_matches_sequential(ranks):
    from repro_torch.parallel.pipeline import bubble_fraction
    outs, _ = ranks
    ws, xs = _pipe_inputs()
    ref = torch.from_numpy(xs)
    for s in range(S_STAGES):
        ref = torch.tanh(ref @ torch.from_numpy(ws[s]))
    for out in outs:
        assert np.abs(out["pipe"] - ref.numpy()).max() < 1e-5
    assert bubble_fraction(S_STAGES, M_MICRO) == 3 / 11


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shard_map_moe_matches_moe_block(dtype, ranks):
    outs, _ = ranks
    for out in outs:
        err = np.abs(out[f"moe_ep_{dtype}"] - out[f"moe_block_{dtype}"]).max()
        assert err == 0.0


def test_shard_map_moe_matches_reference_forward(ranks):
    outs, ref = ranks
    scale = np.abs(ref).max()
    for out in outs:
        assert np.abs(out["moe_ep_float32"] - ref).max() / scale < 1e-4


# --------------------------------------------------------------------------
# the rank processes (this file as a script)
# --------------------------------------------------------------------------

def _rank_main(rank, world, init, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import smoke_config
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.models import model as TM
    from repro_torch.parallel.compression import dp_allreduce, zero_residuals
    from repro_torch.parallel.pipeline import make_pipelined_apply
    from repro_torch.parallel.sharding import ShardingPolicy, use_policy

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    res = {}
    dmesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    g = torch.from_numpy(_dp_grads()[rank])
    for c in ("none", "bf16"):
        mean, resid = dp_allreduce(dmesh, "data", compression=c)(
            {"w": g}, zero_residuals({"w": g}))
        res[f"dp_{c}_mean"] = mean["w"].numpy()
        res[f"dp_{c}_resid"] = resid["w"].numpy()

    pmesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    ws, xs = _pipe_inputs()
    pipe = make_pipelined_apply(pmesh, "stage",
                                lambda p, x: torch.tanh(x @ p["w"]))
    res["pipe"] = pipe({"w": torch.from_numpy(ws)},
                       torch.from_numpy(xs)).numpy()

    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data",
                                                                "model"))
    base = dataclasses.replace(smoke_config("deepseek-moe-16b"), **MOE)
    with np.load(os.path.join(out_dir, "moe_params.npz")) as z:
        leaves = [torch.from_numpy(z[f"arr_{i}"]) for i in range(len(z))]
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
        struct = tree_flatten(TM.init_params(cfg, device="meta"))
        params = tree_unflatten(struct[1], [
            x.to(t.dtype) for x, t in zip(leaves, struct[0])])
        tokens = torch.from_numpy(_moe_tokens(cfg.vocab))
        with use_policy(ShardingPolicy(mesh)):
            res[f"moe_block_{dtype}"] = TM.forward(
                cfg, params, tokens).float().numpy()
            res[f"moe_ep_{dtype}"] = TM.forward(
                dataclasses.replace(cfg, moe_impl="shard_map"), params,
                tokens).float().numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": True}))


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
