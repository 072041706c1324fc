"""The plain references against hand-sized cases, and against the port's
float32 CPU path at a tiny size."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.core import weights as W
from portbench.reference import lowp, mamba2_lm, moe_lm
from portbench.tests import smoke

F32 = lowp.Prec("f32")


def _ssd_sequential(x, dt, A, Bm, Cm):
    b, S, h, p = x.shape
    st = torch.zeros(b, h, p, Bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t] * A)                          # [b,h]
        st = st * da[..., None, None] + torch.einsum(
            "bn,bh,bhp->bhpn", Bm[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], st))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("S,Q", [(12, 4), (10, 4), (8, 8)])
def test_chunked_ssd_is_the_recurrence(S, Q):
    g = torch.Generator().manual_seed(S)
    b, h, p, n = 2, 3, 4, 5
    x = torch.randn(b, S, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(b, S, h, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(h, generator=g, dtype=torch.float64) * 2
    Bm = torch.randn(b, S, n, generator=g, dtype=torch.float64)
    Cm = torch.randn(b, S, n, generator=g, dtype=torch.float64)
    want = _ssd_sequential(x, dt, A, Bm, Cm)

    class P64(lowp.Prec):
        def q(self, t):
            return t
    got = mamba2_lm.ssd(x, dt, A, Bm, Cm, P64(), Q=Q)
    assert torch.allclose(got, want, atol=1e-10)


def test_lr_schedule_by_hand():
    o = {"lr": 1e-3, "warmup_steps": 4, "total_steps": 14, "min_lr_frac": 0.1}
    assert mamba2_lm.lr_at(o, 1) == pytest.approx(2.5e-4)
    assert mamba2_lm.lr_at(o, 4) == pytest.approx(1e-3)
    assert mamba2_lm.lr_at(o, 9) == pytest.approx(1e-3 * (0.1 + 0.9 * 0.5))
    assert mamba2_lm.lr_at(o, 14) == pytest.approx(1e-4)


def test_fp8_rounds_to_three_mantissa_bits():
    t = torch.tensor([1.0, 1.06, 1.07, 448.0, -3.3])
    q = lowp.Prec("fp8").q(t)
    # scale 448/448 = 1: 1.06 rounds to 1.0, 1.07 to 1.125 (step 1/8)
    assert q.tolist() == pytest.approx([1.0, 1.0, 1.125, 448.0, -3.25])
    assert torch.equal(F32.q(t), t)


def test_mamba2_training_step_matches_the_ports_float32_path():
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer
    cell = smoke.train_cell()
    cell.config["model"].update(dtype="float32", param_dtype="float32")
    cfg = W.model_config(cell.config)
    _, w0 = W.make_params(cfg, 5, "cpu")
    tr = cell.traffic
    trainer = Trainer(cfg, OptConfig(**tr["opt"]), batch=4, seq_len=64,
                      use_terra=False, device="cpu")
    for pv, (_, w) in zip(trainer.p_vars, w0):
        pv._value.copy_(w)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 65), dtype=np.int32)
    batch = (toks[:, :-1], toks[:, 1:])
    # the port's optimizer state still holds its own masters: check the
    # loss and gradient of the first step, which do not read them
    loss, gnorm = trainer._iteration(*batch)
    ref = mamba2_lm.train(dict(w0), cell.config,
                          [tuple(torch.from_numpy(a) for a in batch)],
                          tr["opt"], tr["z_loss"])
    assert float(loss) == pytest.approx(ref["loss"][0], rel=1e-5)
    clipped = math.sqrt(sum(v * v for v in ref["grad"].values()))
    sc = min(1.0, tr["opt"]["clip_norm"] / float(gnorm))
    assert clipped == pytest.approx(float(gnorm) * sc, rel=1e-4)


def test_moe_capacity_drops_late_tokens_by_hand():
    m = {"n_experts": 2, "top_k": 1, "capacity_factor": 0.0}
    d, T = 4, 10
    h = torch.eye(d)[:1].repeat(T, 1) * torch.arange(1, T + 1)[:, None]
    p = {"moe.w_router": torch.tensor([[1.0, 0.0]] + [[0.0, 0.0]] * 3),
         "moe.w_gate": torch.ones(2, d, 3), "moe.w_up": torch.ones(2, d, 3),
         "moe.w_down": torch.ones(2, 3, d),
         "moe.shared.w_gate": torch.zeros(d, 3),
         "moe.shared.w_up": torch.zeros(d, 3),
         "moe.shared.w_down": torch.zeros(3, d)}
    out = moe_lm.moe(h, p, m, F32)
    # every token goes to expert 0; capacity max(8, min(0, T)) = 8 keeps
    # the first 8 tokens and drops the last 2
    assert bool((out[:8].abs().sum(1) > 0).all())
    assert bool((out[8:] == 0).all())
    x = h[0]
    want = (F.silu(x @ torch.ones(d, 3)) * (x @ torch.ones(d, 3))) @ \
        torch.ones(3, d)
    assert torch.allclose(out[0], want)


def test_moe_reference_matches_the_ports_float32_forward():
    from repro_torch.models import model as M
    cell = smoke.serve_cell()
    cell.config["model"].update(dtype="float32", param_dtype="float32")
    cfg = W.model_config(cell.config)
    params, w0 = W.make_params(cfg, 9, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 24), dtype=np.int32))
    with torch.no_grad():
        want = M.forward(cfg, params, toks)
    got = moe_lm.logits(dict(w0), cell.config, [toks[0], toks[1]])
    for i in range(2):
        assert torch.allclose(got[i], want[i], atol=2e-4, rtol=1e-4)
