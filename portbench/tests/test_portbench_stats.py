"""The end-to-end metrics' arithmetic: exact percentiles over every
sample, rates over the whole window, busy time as a union of intervals."""

import pytest

from portbench.core import stats
from portbench.core.devtrace import Trace


def test_percentile_is_exact_over_all_samples():
    xs = list(range(1, 101))                      # 1..100
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_a_stall_moves_the_tail_and_the_rate_not_the_median():
    steady = [0.010] * 100
    stalled = [0.010] * 94 + [2.0] * 6             # one stall held 6 tokens
    assert stats.percentile(stalled, 50) == stats.percentile(steady, 50)
    assert stats.percentile(stalled, 95) == pytest.approx(2.0)
    assert stats.percentile(steady, 95) == pytest.approx(0.010)
    # the rate is taken over the whole window, the stall included
    assert stats.rate(100, 0.0, sum(steady)) == pytest.approx(100.0)
    assert stats.rate(100, 0.0, sum(stalled)) == pytest.approx(
        100 / 12.94)


def test_rate_refuses_an_empty_span():
    with pytest.raises(ValueError):
        stats.rate(1, 2.0, 2.0)


def test_busy_is_the_union_of_overlapping_intervals():
    ivs = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert stats.busy(ivs, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.busy(ivs, 2.5, 5.5) == pytest.approx(1.0)
    assert stats.gaps(ivs, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]


def test_trace_idle_share_counts_overlaps_once():
    # two streams overlapping: a sum of durations would read 5 s busy of a
    # 4 s window; the union reads 3 s
    ops = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 1.5, 2.5)]
    kernels = [(n, s, e, i) for i, (n, s, e) in enumerate(ops)]
    tr = Trace(ops, kernels, [("iteration", 2.9, 4.0)], (0.0, 4.0))
    assert tr.busy_s() == pytest.approx(3.0)
    assert 1 - tr.busy_s() / tr.window_s == pytest.approx(0.25)
    bd = tr.breakdown()
    assert bd["idle_gaps"] == [["iteration", pytest.approx(1.0)]]
    assert bd["device_ops"][0] == ["a", pytest.approx(2.0)]


def test_trace_follows_a_kernel_on_its_stream():
    ks = [("x", 0.0, 1.0, 7), ("y", 0.2, 0.5, 8), ("z", 1.0, 1.5, 7),
          ("x", 2.0, 2.5, 8), ("w", 3.0, 3.1, 8)]
    tr = Trace([k[:3] for k in ks], ks, [], (0.0, 4.0))
    assert [k[0] for k in tr.following("^x$")] in (["z", "w"], ["w", "z"])
    assert tr.kernel_count("^x$") == 2
    assert tr.kernel_time("^x$") == pytest.approx(1.5)


def test_spread_is_interquartile_over_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([90, 95, 100, 105, 110]) == pytest.approx(
        (107.5 - 92.5) / 100)
