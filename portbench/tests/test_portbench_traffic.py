"""The traffic generator: deterministic by seed, and every seed the same
set of sizes and gaps in another order."""

import numpy as np
import pytest

from portbench.core import traffic

MIX = {"rate": 4.0,
       "prompt": {"dist": "lognormal", "median": 256, "sigma": 0.6,
                  "min": 32, "max": 768},
       "output": {"dist": "uniform", "min": 32, "max": 224}}


def _key(items):
    return [(it.arrival, it.prompt.tolist(), it.max_new_tokens)
            for it in items]


def test_same_seed_same_requests():
    a = traffic.requests(MIX, 2 ** 31 + 5, 30.0, 1000)
    b = traffic.requests(MIX, 2 ** 31 + 5, 30.0, 1000)
    assert _key(a) == _key(b)


def test_seeds_share_sizes_and_gaps_in_another_order():
    a = traffic.requests(MIX, 1, 30.0, 1000)
    b = traffic.requests(MIX, 2, 30.0, 1000)
    assert _key(a) != _key(b)
    assert sorted(len(x.prompt) for x in a) == sorted(len(x.prompt)
                                                      for x in b)
    assert sorted(x.max_new_tokens for x in a) == sorted(
        x.max_new_tokens for x in b)
    assert len(a) == len(b) == 120
    # the same gaps, the first left out: both spans near the window
    for items in (a, b):
        assert 27.0 < items[-1].arrival < 30.0


def test_sizes_follow_the_mix():
    items = traffic.requests(MIX, 3, 30.0, 1000)
    lens = [len(x.prompt) for x in items]
    outs = [x.max_new_tokens for x in items]
    assert min(lens) >= 32 and max(lens) <= 768
    assert abs(np.median(lens) - 256) <= 8
    assert min(outs) >= 32 and max(outs) <= 224
    assert items[0].arrival == 0.0
    assert all(x.arrival < 30.0 for x in items)
    assert all(b.arrival >= a.arrival for a, b in zip(items, items[1:]))
    assert all(0 <= t < 1000 for x in items for t in x.prompt)


@pytest.mark.parametrize("dist,lo,hi", [
    ({"dist": "loguniform", "min": 512, "max": 2000}, 512, 2000),
    ({"dist": "uniform", "min": 16, "max": 64}, 16, 64),
    ({"dist": "fixed", "value": 7}, 7, 7)])
def test_distributions_stay_in_range(dist, lo, hi):
    xs = traffic.sizes(dist, 200)
    assert min(xs) >= lo and max(xs) <= hi
    if lo < hi:
        assert len(set(xs)) > 10
