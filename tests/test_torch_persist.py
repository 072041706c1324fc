"""The port's persistent artifact store and checkpoints
(repro_torch.core.persist, serve/scheduler/checkpoint.py), on the CPU,
held against the JAX reference.

The eleven tests of tests/test_persist.py run on the port (cross-process
ones in ``device="cpu"`` children sharing one ``$TERRA_CACHE_DIR``): codec
strictness, atomic store semantics, warm boot with zero retraces and zero
segment recompiles, corruption and version skew degrading to a cold start,
eviction-then-reactivation hydrating from disk, engine checkpoint
continuation, and a mid-decode scheduler checkpoint continuing with
exactly the uninterrupted tokens across a process boundary.  Then the two
packages side by side: the warm and cold counters of the same program are
the reference's, and checkpoints the reference wrote (engine and
scheduler) restore into the port and continue with the reference's
outputs.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Variable, function, ops  # noqa: E402
from repro_torch.core.persist import codec  # noqa: E402
from repro_torch.core.persist.store import ArtifactStore  # noqa: E402
from repro_torch.core.trace import Aval, FeedRef, Ref, VarRef  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("retraces", "recompiled", "hits", "warm", "aot", "stored")


def run_sub(code: str, cache_dir: str, *args, **extra_env) -> dict:
    prog = textwrap.dedent(code)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    if cache_dir:
        env["TERRA_CACHE_DIR"] = cache_dir
    else:
        env.pop("TERRA_CACHE_DIR", None)
    env.update({k: str(v) for k, v in extra_env.items()})
    out = subprocess.run([sys.executable, "-c", prog] + list(args), env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ==========================================================================
# codec + store units
# ==========================================================================

def test_codec_roundtrip():
    vals = [None, True, 3, -1.5, "s", (1, (2, "x")), [1, [2]],
            {"a": 1, (1, 2): (3,)}, {3, 1, 2},
            Aval((2, 3), torch.float32), Aval((4,), torch.bfloat16),
            Ref(4, 1), FeedRef(2, 0), VarRef(7), slice(1, None, 2),
            Ellipsis, np.dtype("int32"), torch.bfloat16, np.float32(2.5),
            np.arange(6, dtype=np.int64).reshape(2, 3)]
    for v in vals:
        enc = json.loads(json.dumps(codec.encode(v)))   # JSON-native
        dec = codec.decode(enc)
        if isinstance(v, np.ndarray):
            assert np.array_equal(dec, v) and dec.dtype == v.dtype
        else:
            assert dec == v and type(dec) is type(v)
    # an aval's wire form is the reference's: the dtype by its name
    assert codec.encode(Aval((2,), torch.bfloat16)) == \
        ["aval", [2], "bfloat16"]


def test_codec_is_strict():
    with pytest.raises(codec.CodecError):
        codec.encode(object())                  # unencodable value
    with pytest.raises(codec.CodecError):
        codec.decode(["nosuchtag", 1])          # unknown tag
    with pytest.raises(codec.CodecError):
        codec.decode(["i"])                     # malformed payload
    with pytest.raises(codec.CodecError):       # oversized array
        codec.encode(np.zeros(1 << 20, np.float32))
    with pytest.raises(codec.CodecError):       # a name torch lacks
        codec.decode(["aval", [2], "Tensor"])


def test_store_atomic_and_corrupt(tmp_path):
    st = ArtifactStore(str(tmp_path), "ns")
    assert st.write_json("a/r.json", {"k": [1, 2]}) > 0
    assert st.read_json("a/r.json") == {"k": [1, 2]}
    assert st.read_json("a/absent.json") is None
    with open(os.path.join(str(tmp_path), "ns", "a", "r.json"), "w") as f:
        f.write('{"k": [1,')
    assert st.read_json("a/r.json") is None
    assert st.write_bytes("seg/x.bin", b"\x00\x01") == 2
    assert st.read_bytes("seg/x.bin") == b"\x00\x01"
    st.delete("seg/x.bin")
    assert st.read_bytes("seg/x.bin") is None
    assert "r.json" in st.list("a")


def test_artifacts_written_in_process(tmp_path):
    w = Variable(np.ones(8, np.float32))

    @function(cache_dir=str(tmp_path), device="cpu")
    def step(x):
        y = ops.mul(x, 2.0)
        w.assign(ops.add(w.read(), y))
        return float(ops.reduce_sum(w.read()))

    for i in range(4):
        step(np.full(8, 0.1 * i, np.float32))
    step.wait()
    assert step.stats["artifacts_stored"] > 0
    found = [f for _, _, fs in os.walk(str(tmp_path)) for f in fs]
    assert any(f.endswith(".json") for f in found)      # family record
    step.close()


# ==========================================================================
# cross-process warm boot
# ==========================================================================

TRAIN_PROG = """
    import json
    import numpy as np
    from repro_torch.core import Variable, function, ops

    w = Variable(np.eye(4, dtype=np.float32))

    @function(device="cpu")
    def step(x):
        y = ops.matmul(x, w.read())
        w.assign(ops.add(w.read(), ops.mul(y, 0.01)))
        return float(ops.reduce_sum(y))

    outs = [step(np.full((4, 4), i * 0.1, np.float32)) for i in range(8)]
    step.wait()
    st = step.stats
    print(json.dumps({"outs": outs, "retraces": st["retraces"],
                      "recompiled": st["segments_recompiled"],
                      "hits": st["artifact_hits"],
                      "warm": st["warm_families"],
                      "aot": st["aot_loads"],
                      "stored": st["artifacts_stored"]}))
    step.close()
"""
# the reference's TRAIN_PROG (tests/test_persist.py), the same program
REF_TRAIN_PROG = TRAIN_PROG.replace("repro_torch", "repro").replace(
    '@function(device="cpu")', "@function")


@pytest.fixture(scope="module")
def boots(tmp_path_factory):
    """Cold then warm runs of the program in fresh processes, one cache
    directory per package."""
    out = {}
    for name, prog in (("port", TRAIN_PROG), ("ref", REF_TRAIN_PROG)):
        d = str(tmp_path_factory.mktemp(name))
        out[name] = (run_sub(prog, d), run_sub(prog, d))
    return out


def test_warmboot_cross_process(boots):
    cold, warm = boots["port"]
    assert cold["stored"] > 0 and cold["warm"] == 0
    # the warm-boot contract: nothing traced, nothing recompiled
    assert warm["retraces"] == 0
    assert warm["recompiled"] == 0
    assert warm["hits"] > 0 and warm["warm"] >= 1 and warm["aot"] >= 1
    np.testing.assert_allclose(warm["outs"], cold["outs"], rtol=1e-6)


def test_warmboot_counters_equal_the_reference(boots):
    for (p, r) in zip(boots["port"], boots["ref"]):
        assert {k: p[k] for k in COUNTERS} == {k: r[k] for k in COUNTERS}
        np.testing.assert_allclose(p["outs"], r["outs"], rtol=1e-6)


def test_corruption_falls_back_to_cold(tmp_path):
    cold = run_sub(TRAIN_PROG, str(tmp_path))
    for root, _, files in os.walk(str(tmp_path)):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "r+b") as fh:
                fh.truncate(os.path.getsize(p) // 2)
    warm = run_sub(TRAIN_PROG, str(tmp_path))
    assert warm["warm"] == 0 and warm["aot"] == 0
    np.testing.assert_allclose(warm["outs"], cold["outs"], rtol=1e-6)


def test_version_skew_is_clean_miss(tmp_path):
    cold = run_sub(TRAIN_PROG, str(tmp_path), TERRA_CACHE_SALT="v1")
    skew = run_sub(TRAIN_PROG, str(tmp_path), TERRA_CACHE_SALT="v2")
    assert skew["hits"] == 0 and skew["warm"] == 0      # different namespace
    np.testing.assert_allclose(skew["outs"], cold["outs"], rtol=1e-6)
    warm = run_sub(TRAIN_PROG, str(tmp_path), TERRA_CACHE_SALT="v1")
    assert warm["warm"] >= 1                            # original still hits


# ==========================================================================
# eviction -> reactivation hydrates from disk
# ==========================================================================

def test_evicted_family_rehydrates(tmp_path):
    @function(cache_dir=str(tmp_path), max_families=1, device="cpu")
    def step(x):
        return float(ops.reduce_sum(ops.mul(x, 3.0)))

    a = np.ones(4, np.float32)
    b = np.ones(8, np.float32)
    for _ in range(3):
        assert step(a) == 12.0
    for _ in range(3):
        assert step(b) == 24.0          # evicts family A -> saved to disk
    before = dict(step.stats)
    for _ in range(3):
        assert step(a) == 12.0          # reactivation hydrates, not traces
    step.wait()
    assert step.stats["warm_families"] - before["warm_families"] >= 1
    assert step.stats["traced_iterations"] == before["traced_iterations"]
    step.close()


# ==========================================================================
# engine checkpoint/restore
# ==========================================================================

def _accumulate(w, mod):
    def stepfn(x):
        w.assign(mod.ops.add(w.read(), x))
        return float(mod.ops.reduce_sum(w.read()))
    return stepfn


def test_engine_checkpoint_continuation(tmp_path):
    import repro_torch.core as core
    w = Variable(np.zeros(4, np.float32))
    stepfn = _accumulate(w, core)

    tf1 = function(stepfn, device="cpu")
    feeds = [np.full(4, 0.5, np.float32)] * 4
    for x in feeds:
        tf1(x)
    tf1.save_checkpoint(str(tmp_path / "ck"))
    cont = [tf1(x) for x in feeds]      # the donor's own continuation
    tf1.close()

    tf2 = function(stepfn, device="cpu")  # fresh engine, same Variables
    tf2.restore_checkpoint(str(tmp_path / "ck"))
    resumed = [tf2(x) for x in feeds]
    tf2.wait()
    np.testing.assert_allclose(resumed, cont, rtol=1e-6)
    assert tf2.stats["checkpoint_restores"] == 1
    tf2.close()


def test_engine_restore_raises_on_missing(tmp_path):
    tf = function(lambda x: float(ops.reduce_sum(x)), device="cpu")
    with pytest.raises((OSError, ValueError)):
        tf.restore_checkpoint(str(tmp_path / "nowhere"))
    tf.close()


ENGINE_CKPT_PROG = """
    import json, sys, numpy as np
    from repro_torch.core import Variable, function, ops
    import torch

    # role "save": run 4 steps, checkpoint, run 4 more; role "restore":
    # restore a checkpoint into a fresh engine, then run the same 4.
    # One Variable a dtype, made in the same order in both packages, so
    # the var ids a checkpoint is keyed by agree.
    role, path = sys.argv[1], sys.argv[2]
    out = {}
    for dtype in ("float32", "bfloat16"):
        w = Variable(torch.zeros(4, dtype=getattr(torch, dtype)))

        @function(device="cpu")
        def step(x):
            w.assign(ops.add(w.read(), x))
            return float(ops.reduce_sum(w.read()))

        x = torch.full((4,), 0.5, dtype=getattr(torch, dtype))
        ck = f"{path}_{dtype}"
        if role == "save":
            for _ in range(4):
                step(x)
            step.save_checkpoint(ck)
        else:
            step.restore_checkpoint(ck)
        out[dtype] = [step(x) for _ in range(4)]
        step.wait()
        out[dtype + "_restores"] = step.stats["checkpoint_restores"]
        step.close()
    print(json.dumps(out))
"""
# the same program on the reference (its arrays are jax.numpy's)
REF_ENGINE_CKPT_PROG = ENGINE_CKPT_PROG.replace(
    "repro_torch", "repro").replace(
    "import torch", "import jax.numpy as jnp").replace(
    "torch.zeros(4, dtype=getattr(torch, dtype))",
    "jnp.zeros(4, dtype)").replace(
    "torch.full((4,), 0.5, dtype=getattr(torch, dtype))",
    "jnp.full(4, 0.5, dtype)").replace(
    '@function(device="cpu")', "@function")


def test_engine_checkpoints_cross_between_the_packages(tmp_path):
    """``save_engine`` of the reference, ``restore_checkpoint`` of the
    port: the port continues with the reference's outputs; and the port's
    checkpoint restores into the reference the same way.  float32 and
    bfloat16 buffers (bfloat16 crosses as bit patterns, without
    ml_dtypes in the port)."""
    ref_ck, port_ck = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = run_sub(REF_ENGINE_CKPT_PROG, "", "save", ref_ck)
    port = run_sub(ENGINE_CKPT_PROG, "", "restore", ref_ck)
    port_saved = run_sub(ENGINE_CKPT_PROG, "", "save", port_ck)
    ref_restored = run_sub(REF_ENGINE_CKPT_PROG, "", "restore", port_ck)
    for dtype in ("float32", "bfloat16"):
        assert port[dtype] == ref[dtype], dtype
        assert ref_restored[dtype] == port_saved[dtype], dtype
        assert port[dtype + "_restores"] == 1
    assert ref["float32"] == [10.0, 12.0, 14.0, 16.0]


# ==========================================================================
# scheduler checkpoint: exact continuation across a process boundary
# ==========================================================================

SCHED_PROG = """
    import json, sys, numpy as np, torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    role, path = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    cfg = smoke_config("llama3-8b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab, 4 + i).astype(np.int32)
               for i in range(6)]
    reqs = [Request(prompt=p, max_new_tokens=10, arrival_time=0.0)
            for p in prompts]
    kw = dict(max_slots=4, max_len=64, temperature=0.0, page_size=8,
              device="cpu")

    if role == "ref":
        sch = ContinuousBatchingScheduler(cfg, params, **kw)
        sch.serve(reqs)
        print(json.dumps({"toks": [r.out_tokens for r in reqs]}))
    elif role == "ckpt":
        sch = ContinuousBatchingScheduler(cfg, params, **kw)
        for r in reqs:
            sch.submit(r)
        sch.run(max_steps=7)    # stop mid-decode: 4 in flight, 2 queued
        sch.checkpoint(path)
        assert sch.pool.active_count > 0 and len(sch.queue) > 0
        print(json.dumps({"partial": {r.rid: r.out_tokens or []
                                      for r in reqs}}))
    else:
        sch = ContinuousBatchingScheduler.restore(path, cfg, params,
                                                  device="cpu")
        partial = json.load(open(path + "/partial.json"))
        tracked = {r.rid: r for _, r in sch.pool.active_items()}
        tracked.update({r.rid: r for r in sch.queue._queue})
        sch.run()
        full = {int(k): v for k, v in partial.items()}
        for rid, r in tracked.items():
            full[rid] = r.out_tokens
        print(json.dumps({"toks": [full[rid] for rid in sorted(full)]}))
    sch.close()
"""


def test_scheduler_checkpoint_token_equality(tmp_path):
    ck = str(tmp_path / "sched_ck")
    ref = run_sub(SCHED_PROG, "", "ref", ck)
    partial = run_sub(SCHED_PROG, "", "ckpt", ck)["partial"]
    with open(ck + "/partial.json", "w") as f:
        json.dump(partial, f)
    resumed = run_sub(SCHED_PROG, "", "resume", ck)
    assert resumed["toks"] == ref["toks"]


@pytest.mark.parametrize("page_size", [None, 8], ids=["dense", "paged"])
def test_reference_scheduler_checkpoint_restores_into_the_port(tmp_path,
                                                               page_size):
    """``save_scheduler`` of the reference, mid-decode with requests in
    flight and queued; ``ContinuousBatchingScheduler.restore`` of the
    port: the remaining tokens are the reference's."""
    import jax
    from repro.configs import smoke_config as j_smoke
    from repro.models import model as JM
    from repro.serve.engine import Request as JRequest
    from repro.serve.scheduler import ContinuousBatchingScheduler as JSched
    from repro_torch.configs import smoke_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    f32 = dict(dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), **f32)
    tcfg = dataclasses.replace(smoke_config("llama3-8b"), **f32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, jcfg.vocab, 4 + i).astype(np.int32)
               for i in range(6)]
    kw = dict(max_slots=4, max_len=64, temperature=0.0, page_size=page_size)
    ck = str(tmp_path / "ck")

    ref = [JRequest(prompt=p, max_new_tokens=10, arrival_time=0.0)
           for p in prompts]
    sch = JSched(jcfg, jp, **kw)
    sch.serve(ref)
    sch.close()
    reqs = [JRequest(prompt=p, max_new_tokens=10, arrival_time=0.0)
            for p in prompts]
    sch = JSched(jcfg, jp, **kw)
    for r in reqs:
        sch.submit(r)
    sch.run(max_steps=7)
    assert sch.pool.active_count > 0 and len(sch.queue) > 0
    sch.checkpoint(ck)
    sch.close()
    full = {r.rid: r.out_tokens or [] for r in reqs}

    port = ContinuousBatchingScheduler.restore(ck, tcfg, tp, device="cpu")
    tracked = {r.rid: r for _, r in port.pool.active_items()}
    tracked.update({r.rid: r for r in port.queue._queue})
    port.run()
    assert port.stats["checkpoint_restores"] == 1
    port.close()
    for rid, r in tracked.items():
        full[rid] = r.out_tokens
    assert [full[rid] for rid in sorted(full)] == \
        [r.out_tokens for r in ref]
