"""The frozen bound functions against values worked out by hand."""

import pytest

from portbench.roofline import bounds, peaks


def test_ssd_pairs_counts_causal_pairs_of_64_token_chunks():
    assert bounds.ssd_pairs(64) == 64 * 65 // 2
    assert bounds.ssd_pairs(2048) == 32 * 2080
    assert bounds.ssd_pairs(100) == 2080 + 36 * 37 // 2


def test_ssd_bwd_bound_at_the_launchers_shape():
    # bytes-bound: 3 x,dy,dx + 4 B,C,dB,dC + 2 dt,ddt + 2 A,dA
    B, S, H, P, N = 8, 2048, 24, 64, 128
    nbytes = (3 * B * S * H * P * 2 + 4 * B * S * N * 2 + 2 * B * S * H * 2
              + 2 * H * 4)
    assert nbytes == 169345216
    assert bounds.ssd_bwd_bound_ms(B, S, H, P, N) == pytest.approx(
        1e3 * nbytes / 3.35e12)
    assert bounds.ssd_bwd_bound_ms(B, S, H, P, N) == pytest.approx(
        0.05055, abs=5e-6)
    # doubling the batch doubles a bytes-bound call
    assert bounds.ssd_bwd_bound_ms(16, S, H, P, N) == pytest.approx(
        2 * bounds.ssd_bwd_bound_ms(B, S, H, P, N))


def test_paged_bound_reads_each_valid_position_once():
    # two rows of 100 and 20 tokens, 16 x 128 heads (deepseek), pages of 16
    ms = bounds.paged_bound_ms([100, 20], 16, 16, 128, 16)
    kv = 120 * 16 * 128 * 2 * 2
    q_out = 2 * (2 * 16 * 128) * 2
    table = (7 + 2) * 4 + 2 * 4
    assert ms == pytest.approx(1e3 * (kv + q_out + table) / 3.35e12)
    # a window caps the positions read
    assert bounds.paged_bound_ms([100], 16, 16, 128, 16, window=10) < \
        bounds.paged_bound_ms([100], 16, 16, 128, 16)


def test_attention_bound_is_operations_bound_when_long():
    ms = bounds.attn_bound_ms(1, 32, 4096, 4096, 128,
                              pairs=4096 * 4097 // 2)
    ops = 4 * 128 * 32 * 4096 * 4097 // 2
    assert ms == pytest.approx(1e3 * ops / peaks.BF16_OPS_PER_S)


def test_parameter_counts_from_the_configs_sizes():
    from portbench.core import env, manifest, weights
    env.prepare()
    from repro_torch.models import model as M
    for name, active in (("mamba2-130m", 128903040),
                         ("deepseek-moe-16b", 2620915712)):
        cfg = manifest.load_json(f"{env.ROOT}/portbench/configs/{name}.json")
        assert weights.count(cfg, active=False) == M.param_count(
            weights.model_config(cfg))
        assert weights.count(cfg, active=True) == active
