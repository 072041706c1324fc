"""Each cell's comparison catches the faults its timed path can have.

The harness's look for a card is skipped and the rest of a run is driven
on the CPU at a tiny size, with the timed path broken underneath; the run
must come out not correct against the cell's own limits."""

import pytest

from portbench.tests import smoke


def test_training_step_that_leaves_its_state_unchanged(monkeypatch):
    import repro_torch.train.optimizer as opt

    def unchanged(cfg, state, grads, params):
        new_state = dict(state, step=state["step"] + 1)
        return params, new_state, {"grad_norm": opt.global_norm(grads),
                                   "lr": opt.schedule(cfg, new_state["step"])}
    monkeypatch.setattr(opt, "apply", unchanged)
    _, out = smoke.run(smoke.train_cell())
    got = {n: v for n, v, _ in out.checks}
    assert got["change_gap"] == pytest.approx(1.0)
    assert not out.correct


def test_training_step_that_takes_half_its_batch(monkeypatch):
    import repro_torch.train.train_step as ts
    full = ts.lm_loss

    def half(cfg, params, tokens, labels, **kw):
        n = tokens.shape[0] // 2
        return full(cfg, params, tokens[:n], labels[:n], **kw)
    monkeypatch.setattr(ts, "lm_loss", half)
    _, out = smoke.run(smoke.train_cell())
    assert not out.correct


def test_served_token_altered_where_it_is_produced(monkeypatch):
    import repro_torch.serve.scheduler.pool_ops as po
    sample = po._sample

    def altered(logits, temperature, rng):
        return (sample(logits, temperature, rng) + 1) % logits.shape[-1]
    monkeypatch.setattr(po, "_sample", altered)
    _, out = smoke.run(smoke.serve_cell())
    assert out.failed == 0 and not out.correct


def test_sound_runs_report_every_number():
    for cell in (smoke.train_cell(), smoke.serve_cell()):
        spec, out = smoke.run(cell)
        assert out.attempted > 0 and out.failed == 0
        names = {m["name"] for m in cell.end_to_end}
        assert names <= set(out.end_to_end)
        assert {n for n, _, _ in out.checks} == set(cell.limits)
