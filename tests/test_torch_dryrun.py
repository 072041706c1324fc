"""The port's analytic launch tools against the JAX reference, on the CPU.

``repro_torch.launch.{roofline,dryrun,report,hillclimb}`` count one
step's FLOPs, bytes, collectives and memory per card on ``meta`` tensors
over a fake process group (no card, no allocation).  Held here:

* ``analytic_memory_bytes`` and ``model_flops`` equal the reference's
  exactly for every arch x shape of the registry (the reference's
  ``model_flops`` recomputed from its own ``active_param_count``:
  importing ``repro.launch.dryrun`` forces 512 XLA host devices);
* ``collective_bytes`` per kind equals the reference's HLO parser on the
  same collectives; ``Roofline.as_dict`` has the reference's keys;
  ``report`` renders one result list as the reference does (with the
  reference's peak patched to the port's); ``hillclimb`` runs the
  reference's experiments (theirs read in a subprocess);
* whole cells: the smoke llama3-8b on a 2 x 2 mesh, decode [4 x 64] and
  train [16 x 64], against the reference's dry run in a subprocess with
  ``jax.make_mesh`` patched to Auto axes (jax 0.9 makes Explicit axes,
  which the reference's ``with_sharding_constraint`` refuses): FLOPs,
  wire bytes per kind, the collective count and the memory report within
  stated bands, and the port's own counts pinned for the torch release
  the bands were measured on;
* the counter's reshard-and-retry: only DTensor's refusals are retried,
  each counted (``resharded_ops``, printed by ``report``);
* the per-card count: a column-parallel matmul on a fake 16 x 16 mesh
  counts its local shard's FLOPs, an all-to-all counts as one, the
  two-point extrapolation equals a direct count, nothing is allocated off
  ``meta`` and no process group is left behind; llama3-8b x decode_32k x
  single at its published width is ``ok`` and fits.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_SHAPES = {"smoke_decode": ("decode", 64, 4),
                "smoke_train": ("train", 64, 16)}

# the reference's dry run of the smoke cells, in a process of its own
REF_CELLS = textwrap.dedent("""
    import json, sys
    import repro.launch.dryrun as D          # forces 512 host devices
    import jax
    from jax.sharding import AxisType
    _make = jax.make_mesh
    jax.make_mesh = lambda shape, names, **kw: _make(
        shape, names, axis_types=(AxisType.Auto,) * len(shape), **kw)
    import repro.configs.registry as REG
    from repro.configs import SHAPES, ShapeConfig, smoke_config
    REG.ARCHS["llama3-8b"] = smoke_config("llama3-8b")
    shapes = json.loads(sys.argv[1])
    for name, (kind, seq, batch) in shapes.items():
        SHAPES[name] = ShapeConfig(name, kind, seq, batch)
    recs = [D.run_cell("llama3-8b", name, "single", verbose=False,
                       opts={"mesh_shape": (2, 2)}) for name in shapes]
    print("RESULT " + json.dumps(recs))
""")

REF_HILLCLIMB = textwrap.dedent("""
    import json
    from repro.launch.hillclimb import EXPERIMENTS
    print("RESULT " + json.dumps([e[:5] for e in EXPERIMENTS]))
""")


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def _result(proc, timeout):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the reference comparisons run with JAX on the CPU")
    return jax


@pytest.fixture
def smoke_llama(monkeypatch):
    """The smoke llama3-8b registered as ``llama3-8b`` with the smoke
    shapes, for the port's dry run."""
    import repro_torch.configs.registry as REG
    from repro_torch.configs import SHAPES, ShapeConfig, smoke_config
    monkeypatch.setitem(REG.ARCHS, "llama3-8b", smoke_config("llama3-8b"))
    for name, (kind, seq, batch) in SMOKE_SHAPES.items():
        monkeypatch.setitem(SHAPES, name, ShapeConfig(name, kind, seq, batch))
    return REG.ARCHS["llama3-8b"]


@pytest.fixture(scope="module")
def counts_once(jax_ref):
    """Both packages' parameter counts computed once per config (the
    reference's traces its init each call)."""
    import functools
    from repro.models import model as JM
    from repro_torch.models import model as TM
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JM, TM):
            count = functools.cache(mod.param_count)
            mp.setattr(mod, "param_count", count)
            mp.setattr(mod, "active_param_count",
                       functools.cache(mod.active_param_count))
        yield


def _cells():
    from repro_torch.configs import SHAPES
    from repro_torch.configs.registry import ARCHS
    return [(a, s) for a in sorted(ARCHS) for s in SHAPES]


# --------------------------------------------------------------------------
# whole cells against the reference
# --------------------------------------------------------------------------

# The bands below hold on torch 2.13 (the CPU build the tests run on);
# the port's own numbers are pinned exactly for that version in
# test_smoke_cells_pin_the_port_plan, so a change in DTensor's plan fails
# loudly there.  They do not all hold on torch 2.11: its DTensor refuses
# more views (18 and 111 counter fallbacks at these cells), makes 2.75x
# the reference's collectives in train and peaks 1.27x its memory; FLOPs
# and the total wire bytes stay inside the bands.
#
# FLOPs: the port counts matmul-class FLOPs only (torch.utils.flop_counter's
# formulas, on local shapes); XLA's cost analysis counts every HLO op
# (elementwise, reductions, the optimizer).  The smoke decode step is a few
# tiny matmuls, so the ops the port leaves out are half of XLA's count
# there (port/XLA 0.50); the train step is matmul-bound (0.93).
FLOPS_RATIO = {"decode": (0.45, 1.0), "train": (1 / 1.5, 1.5)}
# Collectives: the two plans move about the same bytes in all but do not
# make the same collectives.  DTensor reduce-scatters gradients into their
# FSDP shards where XLA on the CPU (which forms no reduce-scatter)
# all-reduces and slices, so reductions are compared as all-reduce plus
# reduce-scatter; in decode DTensor moves a KV shard by all-to-all where
# XLA gathers.  The reference's HLO parser reads the result shape of an
# all-gather (this jax prints operands without shapes: the gathered
# tensor) and XLA on the CPU carries the model's bf16 tensors as f32; the
# port logs each all-gather's local operand in its own dtype, and gathers
# a weight shard again for the remat recompute and the backward, where XLA
# keeps the gathered weight.  Measured port/reference: total wire 1.06
# (decode) and 1.05 (train); each kind within 18 % of the total; DTensor
# makes one collective per tensor and mesh dim where XLA combines them, so
# the count is 1.7x and 2.2x.
WIRE_TOTAL_RTOL = 0.15
WIRE_KIND_OF_TOTAL = 0.2
N_COLLECTIVES_RATIO = (1.0, 2.5)
# Memory: the port's peak is the eager step's live storages (every op's
# output until it is freed, nothing fused); XLA's is its buffer assignment
# after fusion.  Arguments are the same tensors (the decode cell's bytes
# equal; train: the port's step takes the whole batch and shards each
# microbatch itself, 4,096 bytes more than the reference's).  Measured
# total_nonalias_bytes port/reference: 1.06 (decode), 1.16 (train).
MEMORY_RTOL = 0.25
_KIND_GROUPS = {"all-gather": ("all-gather",),
                "reductions": ("all-reduce", "reduce-scatter"),
                "all-to-all": ("all-to-all",),
                "collective-permute": ("collective-permute",)}


def _wire(per_coll):
    return sum(v for k, v in per_coll.items() if k != "n_collectives")


@pytest.fixture(scope="module")
def port_smoke_cells():
    """The port's records of the two smoke cells, run once."""
    import repro_torch.configs.registry as REG
    from repro_torch.configs import SHAPES, ShapeConfig, smoke_config
    from repro_torch.launch import dryrun as D
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(REG.ARCHS, "llama3-8b", smoke_config("llama3-8b"))
        for name, (kind, seq, batch) in SMOKE_SHAPES.items():
            mp.setitem(SHAPES, name, ShapeConfig(name, kind, seq, batch))
        return [D.run_cell("llama3-8b", name, "single", verbose=False,
                           opts={"mesh_shape": (2, 2)})
                for name in SMOKE_SHAPES]


def test_smoke_cells_match_the_reference_dry_run(jax_ref, port_smoke_cells):
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CELLS, json.dumps(SMOKE_SHAPES)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        theirs = _result(ref, timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
    mine = port_smoke_cells
    for m, t in zip(mine, theirs):
        assert m["status"] == t["status"] == "ok", (m.get("error"),
                                                    t.get("error"))
        # the port's one added key: the counter's fallbacks
        assert set(m) == set(t) | {"resharded_ops"}
        assert m["resharded_ops"] == {}
        assert m["model_flops_total"] == t["model_flops_total"]
        assert m["analytic_memory"] == t["analytic_memory"]
        assert m["n_chips"] == t["n_chips"] == 4
        assert set(m["roofline"]) == set(t["roofline"])
        assert (m["roofline"]["model_flops_per_device"]
                == t["roofline"]["model_flops_per_device"])
        kind = SMOKE_SHAPES[m["shape"]][0]
        lo, hi = FLOPS_RATIO[kind]
        ratio = m["roofline"]["flops"] / t["roofline"]["flops"]
        assert lo <= ratio <= hi, (m["shape"], m["roofline"]["flops"],
                                   t["roofline"]["flops"])
        mc, tc = m["roofline"]["per_coll"], t["roofline"]["per_coll"]
        total = _wire(tc)
        assert abs(_wire(mc) - total) <= WIRE_TOTAL_RTOL * total, (mc, tc)
        for group, kinds in _KIND_GROUPS.items():
            diff = sum(mc[k] for k in kinds) - sum(tc[k] for k in kinds)
            assert abs(diff) <= WIRE_KIND_OF_TOTAL * total, (group, mc, tc)
        n_lo, n_hi = N_COLLECTIVES_RATIO
        assert (n_lo * tc["n_collectives"] <= mc["n_collectives"]
                <= n_hi * tc["n_collectives"]), (mc, tc)
        mm, tm = m["memory"], t["memory"]
        if kind == "decode":
            assert (mm["argument_size_in_bytes"]
                    == tm["argument_size_in_bytes"])
            assert mm["alias_size_in_bytes"] == tm["alias_size_in_bytes"]
        assert (abs(mm["total_nonalias_bytes"] - tm["total_nonalias_bytes"])
                <= MEMORY_RTOL * tm["total_nonalias_bytes"]), (mm, tm)
        print(f"{m['shape']}: flops port {m['roofline']['flops']:.0f} "
              f"reference {t['roofline']['flops']:.0f}; wire port "
              f"{_wire(mc):.0f} reference {total:.0f}; memory port "
              f"{mm['total_nonalias_bytes']} reference "
              f"{tm['total_nonalias_bytes']}")


# the port's counts at the smoke cells on torch 2.13 (the CPU build the
# tests run on): FLOPs, wire bytes per kind, the collective count and the
# memory report
PINNED_TORCH = "2.13"
PINNED = {
    "smoke_decode": {
        "flops": 172032.0,
        "per_coll": {"all-gather": 125332.0, "all-reduce": 1024.0,
                     "reduce-scatter": 0.0, "all-to-all": 24576.0,
                     "collective-permute": 0.0, "n_collectives": 25},
        "memory": {"argument_size_in_bytes": 59788,
                   "output_size_in_bytes": 8204,
                   "temp_size_in_bytes": 221188,
                   "alias_size_in_bytes": 8196,
                   "total_nonalias_bytes": 280984}},
    "smoke_train": {
        "flops": 132120576.0,
        "per_coll": {"all-gather": 1916928.0, "all-reduce": 536896.0,
                     "reduce-scatter": 1474560.0, "all-to-all": 0.0,
                     "collective-permute": 0.0, "n_collectives": 352},
        "memory": {"argument_size_in_bytes": 369284,
                   "output_size_in_bytes": 361104,
                   "temp_size_in_bytes": 949012,
                   "alias_size_in_bytes": 0,
                   "total_nonalias_bytes": 1679400}},
}


def test_smoke_cells_pin_the_port_plan(port_smoke_cells):
    """DTensor's plan of the smoke cells, exactly: a torch release that
    plans otherwise fails here, and its numbers go beside these."""
    if not torch.__version__.startswith(PINNED_TORCH + "."):
        pytest.skip(f"the pinned counts are torch {PINNED_TORCH}'s; this "
                    f"is torch {torch.__version__}")
    for rec in port_smoke_cells:
        assert rec["status"] == "ok", rec.get("error")
        want = PINNED[rec["shape"]]
        got = {"flops": rec["roofline"]["flops"],
               "per_coll": rec["roofline"]["per_coll"],
               "memory": rec["memory"]}
        assert got == want, (rec["shape"], got)


# --------------------------------------------------------------------------
# the analytic terms, arch by arch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", _cells())
def test_analytic_memory_and_model_flops_match_reference(arch, shape,
                                                         counts_once):
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get
    from repro.launch import roofline as JR
    from repro.models import model as JM
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as TR
    for n_chips in (256, 512):
        for mb in (1, D.TRAIN_MICROBATCHES):
            assert TR.analytic_memory_bytes(
                get_config(arch), SHAPES[shape], n_chips, mb) == \
                JR.analytic_memory_bytes(j_get(arch), J_SHAPES[shape],
                                         n_chips, mb)
    # the reference's model_flops (repro/launch/dryrun.py), on its counts
    js = J_SHAPES[shape]
    n = JM.active_param_count(j_get(arch))
    toks = js.global_batch * (js.seq_len if js.kind != "decode" else 1)
    want = (6.0 if js.kind == "train" else 2.0) * n * toks
    assert D.model_flops(get_config(arch), SHAPES[shape]) == want


def test_collective_bytes_match_the_hlo_parser(jax_ref):
    from repro.launch import roofline as JR
    from repro_torch.launch import roofline as TR
    hlo = "\n".join([
        "%ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} %p), "
        "dimensions={0}",
        "%ar = f32[8,1024]{1,0} all-reduce(f32[8,1024]{1,0} %x), "
        "to_apply=%add",
        "%ars = f32[64]{0} all-reduce-start(f32[64]{0} %y), to_apply=%add",
        "%rs = bf16[2,512]{1,0} reduce-scatter(bf16[32,512]{1,0} %g), "
        "dimensions={0}",
        "%a2a = bf16[4,128,64]{2,1,0} all-to-all(bf16[4,128,64]{2,1,0} %t), "
        "dimensions={0}",
        "%cp = s32[3,5]{1,0} collective-permute(s32[3,5]{1,0} %z), "
        "source_target_pairs={{0,1}}",
        "%add.1 = f32[8,1024]{1,0} add(f32[8,1024]{1,0} %a, f32[8,1024] %b)",
    ])
    log = [("all-gather", (1, 4096), "bfloat16"),
           ("all-reduce", (8, 1024), "float32"),
           ("all-reduce", (64,), "float32"),
           ("reduce-scatter", (32, 512), "bfloat16"),
           ("all-to-all", (4, 128, 64), "bfloat16"),
           ("collective-permute", (3, 5), "int32")]
    want = JR.collective_bytes(hlo)
    assert want["n_collectives"] == 6
    assert TR.collective_bytes(log) == want


def test_roofline_dict_has_the_reference_keys(jax_ref):
    from repro.launch import roofline as JR
    from repro_torch.launch import roofline as TR
    args = dict(flops=2.0, bytes_accessed=3.0, wire_bytes=4.0, compute_s=1.0,
                memory_s=2.0, collective_s=0.5, per_coll={"all-gather": 4.0},
                model_flops_per_device=1.0)
    t, j = TR.Roofline(**args).as_dict(), JR.Roofline(**args).as_dict()
    assert t == j and t["dominant"] == "memory" and t["useful_ratio"] == 0.5


def _synthetic_results():
    def cell(arch, shape, mesh, c, m, k, mf, fits=True, **extra):
        return dict(arch=arch, shape=shape, mesh=mesh, opts={}, status="ok",
                    lower_s=0.5, compile_s=1.5, fits_hbm=fits,
                    memory={"total_nonalias_bytes": 3 * 2 ** 30},
                    roofline=dict(compute_s=c, memory_s=m, collective_s=k,
                                  dominant=max(
                                      {"compute": c, "memory": m,
                                       "collective": k}.items(),
                                      key=lambda kv: kv[1])[0],
                                  useful_ratio=0.5,
                                  model_flops_per_device=mf), **extra)
    return [
        cell("llama3-8b", "train_4k", "single", 2.0, 1.0, 3.0, 1e15),
        cell("llama3-8b", "decode_32k", "single", 1e-4, 1e-3, 1e-2, 1e10,
             fits=False),
        cell("qwen2.5-14b", "train_4k", "single", 5.0, 1.0, 1.0, 1e14),
        cell("llama3-8b", "train_4k", "multi", 2.0, 1.0, 3.0, 1e15),
        dict(arch="whisper-small", shape="long_500k", mesh="single",
             opts={}, status="skipped", reason="full-attention arch: " * 4),
        dict(arch="mixtral-8x22b", shape="train_4k", mesh="single", opts={},
             status="error", error="RuntimeError: " + "x" * 200),
    ]


def test_report_renders_as_the_reference_does(jax_ref, monkeypatch,
                                              tmp_path):
    from repro.launch import report as JREP
    from repro_torch.launch import report as TREP
    monkeypatch.setattr(JREP, "PEAK_FLOPS_BF16", TREP.PEAK_FLOPS_BF16)
    results = _synthetic_results()
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(results + [dict(results[0], opts={"x": 1})]))
    assert TREP.load(str(path)) == JREP.load(str(path))
    assert TREP.dryrun_summary(results) == JREP.dryrun_summary(results)
    rows = TREP.roofline_rows(results)
    assert rows == JREP.roofline_rows(results) and len(rows) == 3
    assert TREP.render_table(rows) == JREP.render_table(rows)
    assert TREP.pick_hillclimb(rows) == JREP.pick_hillclimb(rows)


def test_report_main_renders_a_file_without_train_cells(tmp_path,
                                                       monkeypatch, capsys):
    """The CLI renders one decode cell's table (the hillclimb candidates
    need a train cell: the reference's picker indexes the first)."""
    from repro_torch.launch import report as TREP
    path = tmp_path / "dry.json"
    path.write_text(json.dumps([r for r in _synthetic_results()
                                if r["shape"] == "decode_32k"]))
    monkeypatch.setattr(sys, "argv", ["report", str(path)])
    TREP.main()
    out = capsys.readouterr().out
    assert "| llama3-8b | decode_32k |" in out
    assert "hillclimb candidates" not in out


def test_hillclimb_runs_the_reference_experiments(jax_ref):
    from repro_torch.launch import hillclimb as H
    proc = subprocess.Popen([sys.executable, "-c", REF_HILLCLIMB],
                            env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    theirs = _result(proc, timeout=120)
    mine = json.loads(json.dumps([e[:5] for e in H.EXPERIMENTS]))
    assert mine == theirs and len(mine) == 14


# --------------------------------------------------------------------------
# the per-card count
# --------------------------------------------------------------------------

def test_column_parallel_matmul_counts_the_local_shard():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import Counter, fake_mesh
    with fake_mesh({"data": 16, "model": 16}) as mesh:
        x = distribute_tensor(torch.empty(256, 4096, dtype=torch.bfloat16,
                                          device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(4096, 14336, dtype=torch.bfloat16,
                                          device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with Counter() as c:
            y = x @ w
        assert y.placements == (Shard(0), Shard(1))
    # one card: [16, 4096] @ [4096, 896]; the whole product would be
    # 30,064,771,072
    assert c.flops == 2 * 16 * 4096 * 896 == 117_440_512
    assert c.collectives == []


def test_all_to_all_counts_as_all_to_all():
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import Counter, fake_mesh
    with fake_mesh({"data": 2, "model": 4}) as mesh:
        x = torch.empty(8, 64, dtype=torch.bfloat16, device="meta")
        out = torch.empty_like(x)
        with Counter() as c:
            # models/moe_ep.py's exchange, and DTensor's Shard(0) -> Shard(1)
            dist.all_to_all_single(out, x, group=mesh.get_group("model"))
            xd = distribute_tensor(torch.empty(16, 32, device="meta"), mesh,
                                   [Shard(0), Shard(0)], src_data_rank=None)
            xd.redistribute(mesh, [Shard(0), Shard(1)])
    assert c.collectives == [("all-to-all", (8, 64), "bfloat16"),
                             ("all-to-all", (2, 32), "float32")]
    per = RL.collective_bytes(c.collectives)
    assert per["all-to-all"] == 8 * 64 * 2 + 2 * 32 * 4
    assert per["all-gather"] == 0 and per["n_collectives"] == 2


def test_refused_views_are_resharded_and_counted():
    """A view DTensor refuses on a sharded input (splitting a dim whose
    mesh axis does not divide the first part) is re-run on the input
    replicated over that dim, counted by op and stage; an error that is
    not DTensor's refusal propagates and is not retried."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import Counter, _refused, fake_mesh
    with fake_mesh({"data": 2, "model": 4}) as mesh:
        x = distribute_tensor(torch.empty(4, 1, 8, dtype=torch.bfloat16,
                                          device="meta"), mesh,
                              [Shard(0), Shard(2)], src_data_rank=None)
        with pytest.raises(RuntimeError) as refused:
            x.view(4, 1, 2, 4)
        assert _refused(refused.value)
        with Counter() as c:
            y = x.view(4, 1, 2, 4)
        assert y.placements == (Shard(0), Replicate())
        assert c.resharded == {"aten.view": {"dims": 1}}
        assert c.collectives == [("all-gather", (2, 1, 2), "bfloat16")]

        def shape_bug(*args, **kwargs):
            raise RuntimeError("a shape bug of the model")

        c = Counter()
        with pytest.raises(RuntimeError, match="a shape bug"):
            c._resharded(shape_bug, (x, (4, 1, 2, 4)), {})
        assert c.resharded == {} and c.collectives == []
    with pytest.raises(RuntimeError) as plain:
        torch.empty(2, device="meta").view(3)
    assert not _refused(plain.value)


def test_report_prints_the_counter_fallbacks(tmp_path, monkeypatch,
                                             capsys):
    from repro_torch.launch import report as TREP
    results = [dict(r, resharded_ops={}) for r in _synthetic_results()
               if r["status"] == "ok"]
    results[1]["resharded_ops"] = {"aten.view": {"dims": 30},
                                   "aten.argmax": {"whole": 2}}
    lines = TREP.resharded_lines(results)
    assert lines[0].endswith("32 in 1 of 4 cells")
    assert lines[1:] == ["  llama3-8b x decode_32k x single: 32 "
                         "(aten.argmax {'whole': 2}, aten.view "
                         "{'dims': 30})"]
    assert TREP.resharded_lines(_synthetic_results()) == []
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(results))
    monkeypatch.setattr(sys, "argv", ["report", str(path)])
    TREP.main()
    assert "llama3-8b x decode_32k x single: 32" in capsys.readouterr().out


def test_extrapolation_equals_a_direct_count(smoke_llama, monkeypatch):
    """Four super-blocks of the smoke llama (a homogeneous stack): the
    two-point extrapolation from 2 and 3 equals counting all four."""
    import dataclasses
    import repro_torch.configs.registry as REG
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    cfg = dataclasses.replace(smoke_llama, n_layers=4)
    monkeypatch.setitem(REG.ARCHS, "llama3-8b", cfg)
    rec = D.run_cell("llama3-8b", "smoke_decode", "single", verbose=False,
                     opts={"mesh_shape": (2, 2)})
    assert rec["status"] == "ok", rec.get("error")
    with D.fake_mesh({"data": 2, "model": 2}) as mesh:
        flops, byt, coll = D._cost_tuple("llama3-8b", "smoke_decode", mesh,
                                         D.reduced_cfg(cfg, 4))
        low, _ = D.lower_cell("llama3-8b", "smoke_decode", mesh)
        mem = RL.memory_report(low.run())
    assert rec["roofline"]["flops"] == flops
    assert rec["xla_bytes_upper_bound"] == byt
    assert rec["roofline"]["per_coll"] == coll
    assert rec["memory"] == mem


def test_run_cell_stays_on_meta_and_leaves_no_group(smoke_llama,
                                                    monkeypatch):
    """Every tensor the dry run makes is a ``meta`` tensor (or a fake one,
    DTensor's sharding propagation), but small CPU integer tensors: the
    mesh's rank table and DTensor's shard bookkeeping.  No CUDA context
    is made and no process group is left."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch import dryrun as D

    class Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.off_meta = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in D._tensors(out):
                t = D._local(t)
                if t.device.type != "meta" and not isinstance(t, FakeTensor):
                    self.off_meta.append((str(func), t.device.type,
                                          t.dtype, t.numel()))
            return out

    with Devices() as seen:
        rec = D.run_cell("llama3-8b", "smoke_train", "single",
                         verbose=False, opts={"mesh_shape": (2, 2)})
    assert rec["status"] == "ok", rec.get("error")
    assert seen.off_meta and all(
        dev == "cpu" and not dt.is_floating_point and n <= 1024
        for _, dev, dt, n in seen.off_meta), seen.off_meta
    assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()
    # and on error too

    def fails(*a, **k):
        assert dist.is_initialized()
        raise RuntimeError("a cell that fails")

    monkeypatch.setattr(D, "lower_cell", fails)
    rec = D.run_cell("llama3-8b", "smoke_train", "single", verbose=False,
                     opts={"mesh_shape": (2, 2)})
    assert rec["status"] == "error" and "a cell that fails" in rec["error"]
    assert not dist.is_initialized()


def test_full_size_decode_cell_runs_and_fits():
    from repro_torch.launch import dryrun as D
    rec = D.run_cell("llama3-8b", "decode_32k", "single", verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["fits_hbm"] and rec["n_chips"] == 256
    r = rec["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] > 0
    assert r["model_flops_per_device"] == D.model_flops(
        D.get_config("llama3-8b"), D.SHAPES["decode_32k"]) / 256
