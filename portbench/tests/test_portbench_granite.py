"""granite-4.0-h-small on the port at a smoke size: the hybrid's forward,
the slot pool's prefill and decode and the padded SSD prefill against
the plain reference (``reference/granite_hybrid_lm.py``), each of the
model's departures from the llama-family block shown to matter, the
reference against a sequential recurrence, and (on the card) the
captured decode step against the uncaptured one.

Seeded random weights from the benchmark's own rule (``core/weights``);
the smoke hybrid keeps one whole period of the published layer pattern
(five Mamba-2 + MoE layers, one NoPE attention + MoE layer, four more)
with small widths, in float32 unless a test says otherwise."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.core import env, manifest
from portbench.core import weights as W
from portbench.reference import granite_hybrid_lm as G
from portbench.reference import lowp

env.prepare()

CELL = "granite-4.0-h-small.longchat"
KERNELS = ("cse", "kernels", "dce", "coalesce")
# float32 through ten layers, the port and the reference summing in other
# orders (the SSD by chunks of 8 against 64, blockwise attention against
# one softmax): differences of a few 1e-7 on logits of magnitude ~0.5
# (measured); 1e-5 leaves room for other BLAS builds and is still far
# below what any dropped mechanism moves (the smallest, NoPE's in the one
# attention layer: 6e-4)
ATOL, RTOL = 1e-5, 1e-4


def smoke_config(dtype="float32") -> dict:
    """The cell's configuration file with the widths cut: one period of
    the pattern, the softmax scale 1/D as published (1/128 at D = 128)."""
    c = copy.deepcopy(manifest.cell(CELL).config)
    c["model"].update(n_layers=10, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=32, moe_d_ff=32, n_experts=8,
                      top_k=3, capacity_factor=8.0, ssm_heads=4,
                      ssm_head_dim=16, ssm_state=16, vocab=128, ssd_chunk=8,
                      attn_scale=1.0 / 16, dtype=dtype, param_dtype=dtype)
    return c


@pytest.fixture(scope="module")
def hybrid():
    c = smoke_config()
    cfg = W.model_config(c)
    params, w = W.make_params(cfg, 3, "cpu")
    return c, cfg, params, dict(w)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tokens(n, S, vocab=128, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (n, S), dtype=np.int32))


def test_hybrid_forward_matches_the_reference(hybrid):
    from repro_torch.models import model as M
    c, cfg, params, w = hybrid
    assert list(cfg.block_pattern).count("ssd_moe") == 9
    toks = _tokens(2, 24)
    with torch.no_grad():
        want = M.forward(cfg, params, toks)
    got = G.logits(w, c, [toks[0], toks[1]])
    for i in range(2):
        torch.testing.assert_close(got[i], want[i], atol=ATOL, rtol=RTOL)


# a config field set back to the llama-family default drops one mechanism
DROPS = {"nope": False, "attn_scale": 0.0, "embedding_multiplier": 1.0,
         "residual_multiplier": 1.0, "logits_scaling": 1.0,
         "ssm_d_skip": False, "ssm_gated_norm": False, "conv_bias": False}


@pytest.mark.parametrize("field", sorted(DROPS))
def test_dropping_a_mechanism_fails_the_comparison(hybrid, field):
    from repro_torch.models import model as M
    c, cfg, params, w = hybrid
    toks = _tokens(1, 24)
    with torch.no_grad():
        got = M.forward(dataclasses.replace(cfg, **{field: DROPS[field]}),
                        params, toks)[0]
    want = G.logits(w, c, [toks[0]])[0]
    assert not torch.allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (got - want).abs().max() > 10 * ATOL


def _served_logits(cfg, params, reqs, **kw):
    """Serve ``reqs`` through the ``use_terra=False`` scheduler and keep
    the logits of every row each step made: [(request, position of the
    logits in prompt + served tokens, logits)]."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.scheduler import pool_ops
    sched = ContinuousBatchingScheduler(cfg, params, use_terra=False,
                                        device="cpu", **kw)
    rows, out = [], []
    head = T.head_logits

    def record(cfg_, params_, x):
        lg = head(cfg_, params_, x)
        out.extend((req, pos, lg[i].clone()) for i, req, pos in rows.pop(0))
        return lg

    dispatch_decode, dispatch_prefill = (sched._dispatch_decode,
                                         sched._dispatch_prefill)

    def decode(plan):
        rows.append([(s, sched.pool.requests[s], int(sched.pool.pos[s]))
                     for s in np.flatnonzero(plan.mask)])
        return dispatch_decode(plan)

    def prefill(plan):
        rows.append([(i, r, len(r.prompt) - 1)
                     for i, r in enumerate(plan.requests)])
        return dispatch_prefill(plan)

    sched._dispatch_decode, sched._dispatch_prefill = decode, prefill
    orig = pool_ops.T.head_logits
    pool_ops.T.head_logits = record
    try:
        sched.serve(reqs)
    finally:
        pool_ops.T.head_logits = orig
    sched.close()
    return out


def _requests(lens, mns, vocab=128, seed=0):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, L, dtype=np.int32),
                    max_new_tokens=n, arrival_time=0.0)
            for L, n in zip(lens, mns)]


POOL = dict(max_slots=3, max_len=64, page_size=8, prefill_batch_cap=2)
LENS, MNS = [13, 8, 21, 5, 11], [6, 9, 5, 7, 3]


def test_scheduler_serves_the_references_logits(hybrid):
    """Prefill (padded to its bucket, two rows at a time) and decode
    through the pool's paged K/V arena and dense recurrent rows give, at
    every served position, the reference's logits over the whole
    sequence; the co-executed scheduler with the ``kernels`` pass serves
    the same tokens."""
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.scheduler.lifecycle import bucket_len
    c, cfg, params, w = hybrid
    assert bucket_len(cfg, 13, 64) == 16            # SSD stacks pad
    reqs = _requests(LENS, MNS)
    got = _served_logits(cfg, params, reqs, **POOL)
    seqs = {id(r): torch.from_numpy(np.concatenate(
        [r.prompt, np.asarray(r.out_tokens[:-1], np.int32)])) for r in reqs}
    ref = {k: G.logits(w, c, [s])[0] for k, s in seqs.items()}
    served = {id(r): 0 for r in reqs}
    for req, pos, lg in got:
        if pos >= len(seqs[id(req)]):
            continue                    # a lagged step past the budget
        torch.testing.assert_close(lg, ref[id(req)][pos], atol=ATOL,
                                   rtol=RTOL)
        served[id(req)] += 1
    assert served == {id(r): r.max_new_tokens for r in reqs}
    co = _requests(LENS, MNS)
    sched = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                        device="cpu", **POOL)
    sched.serve(co)
    st = sched.stats
    sched.close()
    assert [r.out_tokens for r in co] == [r.out_tokens for r in reqs]
    assert st["phase"] == "co-execution" and st["kernels_substituted"] >= 1
    assert st["prefill_tokens"] == sum(LENS)


def test_prefill_sub_spans_nest_in_step_prefill(hybrid):
    """Every prefill's mixer, attention and MoE sub-layers are spans
    inside its ``step.prefill`` (one a layer each); decode steps open
    none."""
    from repro_torch.obs import SpanRecorder
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    _, cfg, params, _ = hybrid
    sched = ContinuousBatchingScheduler(cfg, params, device="cpu", **POOL)
    rec = SpanRecorder()
    sched.events.record_spans(rec)
    sched.serve(_requests(LENS, MNS))
    sched.events.record_spans(None)
    sched.close()
    spans = rec.spans()
    by_id = {sp.id: sp for sp in spans}
    pre = [sp for sp in spans if sp.name == "step.prefill"]
    subs = [sp for sp in spans if sp.name.startswith("step.prefill.")]
    assert pre and all(by_id[sp.parent].name == "step.prefill"
                       for sp in subs)
    per = {p.id: sorted(sp.name for sp in subs if sp.parent == p.id)
           for p in pre}
    assert all(v == ["step.prefill.attention"] + ["step.prefill.mixer"] * 9
               + ["step.prefill.moe"] * 10 for v in per.values())


def _prefill(cfg, params, toks, lengths=None):
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    B, S = toks.shape
    cache = M.init_cache(cfg, B, 64, "cpu")
    x = T.embed_tokens(cfg, params, toks)
    x, cache = T.run_stack(cfg, params, x, positions=torch.arange(S)[None],
                           caches=cache, lengths=lengths)
    return T.head_logits(cfg, params, T._norm(cfg, params["final_norm"],
                                               x)), cache


def _mamba2_smoke():
    from repro_torch.configs import smoke_config as t_smoke
    cfg = dataclasses.replace(t_smoke("mamba2-130m"), dtype="float32",
                              param_dtype="float32")
    params, _ = W.make_params(cfg, 4, "cpu")
    return cfg, params


@pytest.mark.parametrize("model", ["granite-hybrid", "mamba2-130m"])
def test_padded_prefill_equals_exact_length(hybrid, model):
    """Rows padded past their lengths under the length mask leave the SSD
    state and conv window of each row's last real token, and the logits
    there, as an exact-length prefill does (attention's K/V too, at the
    real positions).  The slot pool pads the hybrid's prompts; mamba2's
    it admits at exact length, as the reference scheduler does, though
    its mask holds too."""
    from repro_torch.serve.scheduler.pool_ops import pads_allowed
    cfg, params = (hybrid[1], hybrid[2]) if model == "granite-hybrid" \
        else _mamba2_smoke()
    assert pads_allowed(cfg) == (model == "granite-hybrid")
    lens = [13, 9]
    toks = _tokens(2, 16, cfg.vocab, seed=5)
    with torch.no_grad():
        lg, cache = _prefill(cfg, params, toks,
                             torch.tensor(lens, dtype=torch.int32))
        for b, L in enumerate(lens):
            lg1, c1 = _prefill(cfg, params, toks[b:b + 1, :L])
            torch.testing.assert_close(lg[b, L - 1], lg1[0, -1], atol=ATOL,
                                       rtol=RTOL)
            for slot, (got, want) in enumerate(zip(cache["layers"],
                                                   c1["layers"])):
                for k in got:
                    g, w_ = got[k][:, b], want[k][:, 0]
                    if k in ("k", "v"):
                        g, w_ = g[:, :L], w_[:, :L]
                    torch.testing.assert_close(g, w_, atol=ATOL, rtol=RTOL)


class _P64(lowp.Prec):
    def q(self, t):
        return t


def _mixer_sequential(h, p, m):
    """Mamba-2's mixer one position at a time, in float64: the conv as a
    sum over the last K inputs, the state h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t ⊗ B_t, y_t = h_t C_t + D x_t, the gated norm per position."""
    T = h.shape[0]
    H, P, N, K = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"], \
        m["conv_kernel"]
    di = H * P
    z, xin, Bm, Cm, dt = torch.split(h @ p["ssd.w_in"], [di, di, N, N, H],
                                     -1)
    dt = F.softplus(dt + p["ssd.dt_bias"])
    u = torch.cat([xin, Bm, Cm], -1)
    A = -torch.exp(p["ssd.a_log"])
    st = torch.zeros(H, P, N, dtype=torch.float64)
    ys = []
    for t in range(T):
        conv = p["ssd.b_conv"].clone()
        for k in range(K):
            if t - (K - 1 - k) >= 0:
                conv = conv + u[t - (K - 1 - k)] * p["ssd.w_conv"][:, k]
        conv = F.silu(conv)
        x, B, C = conv[:di].reshape(H, P), conv[di:di + N], conv[di + N:]
        st = st * torch.exp(dt[t] * A)[:, None, None] \
            + dt[t][:, None, None] * x[:, :, None] * B
        y = (st @ C + x * p["ssd.d_skip"][:, None]).reshape(di)
        g = y * F.silu(z[t])
        g = g * torch.rsqrt((g * g).mean() + m["norm_eps"]) \
            * (1 + p["ssd.norm.scale"])
        ys.append(g @ p["ssd.w_out"])
    return torch.stack(ys)


def test_reference_mixer_is_the_sequential_recurrence(hybrid):
    c, _, _, w = hybrid
    m = c["model"]
    p = {k[len("blocks.0."):]: v[0].double() for k, v in w.items()
         if k.startswith("blocks.0.")}
    p["ssd.norm.scale"] = torch.linspace(-0.5, 0.5, 64, dtype=torch.float64)
    h = torch.randn(21, 64, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    got = G.mixer(h, p, m, _P64())
    want = _mixer_sequential(h, p, m)
    torch.testing.assert_close(got, want, atol=1e-10, rtol=1e-10)


def test_reference_attention_is_the_per_query_softmax(hybrid):
    """NoPE GQA by hand: each query's softmax over the keys up to it,
    scores times attn_scale, no positions anywhere."""
    c, _, _, w = hybrid
    m = c["model"]
    p = {k[len("blocks.5."):]: v[0].double() for k, v in w.items()
         if k.startswith("blocks.5.")}
    T, H, Hkv, D = 7, m["n_heads"], m["n_kv_heads"], m["head_dim"]
    h = torch.randn(T, 64, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    q = (h @ p["attn.wq"]).reshape(T, H, D)
    k = (h @ p["attn.wk"]).reshape(T, Hkv, D)
    v = (h @ p["attn.wv"]).reshape(T, Hkv, D)
    o = torch.zeros(T, H, D, dtype=torch.float64)
    for t in range(T):
        for hh in range(H):
            j = hh // (H // Hkv)
            a = torch.softmax(k[:t + 1, j] @ q[t, hh] * m["attn_scale"], 0)
            o[t, hh] = a @ v[:t + 1, j]
    want = o.reshape(T, H * D) @ p["attn.wo"]
    torch.testing.assert_close(G.attention(h, p, m, _P64()), want,
                               atol=1e-10, rtol=1e-10)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured decode step and the "
                    "SSD and paged kernels run there only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_captured_hybrid_decode_equals_uncaptured(card):
    """The smoke hybrid served on the card (paged kernel, SSD kernel,
    steady decode steps captured as CUDA graphs) gives the tokens the
    same scheduler gives with nothing captured; the captured steady step
    writes the recurrent rows back by copy (``pool_copy_bytes``)."""
    from repro_torch.core import capture
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    c = smoke_config()
    cfg = W.model_config(c)
    params, _ = W.make_params(cfg, 3, card)
    lens, mns = [13, 8, 21, 40, 11, 30], [40, 32, 36, 28, 44, 30]

    def serve():
        reqs = _requests(lens, mns)
        s = ContinuousBatchingScheduler(cfg, params, optimize=KERNELS,
                                        device=card,
                                        **dict(POOL, max_len=128))
        s.serve(reqs)
        st = dict(s._tf.engine.capture.stats) \
            if s._tf.engine.capture is not None else None
        s.close()
        return [r.out_tokens for r in reqs], st

    with capture.disable_jit():
        want, _ = serve()
    got, st = serve()
    assert got == want
    assert st["replays"] > 0 and st["pool_copy_bytes"] > 0
