"""The one generator of serving traffic, driven by a mix's parameters.

A run of ``seconds`` at ``rate`` requests a second holds
``round(rate * seconds)`` requests.  Their prompt lengths, output lengths
and gaps between arrivals are the quantiles of the mix's distributions at
evenly spaced probabilities, so every seed draws the same set of sizes
and gaps; the seed only orders them (each in its own order) and draws the
prompts' tokens.  So two seeds do the same work in another order, and a
run's load does not swing with its seed.

Distributions (``{"dist": ..., ...}``):
  ``lognormal``   ``median``, ``sigma``, clipped to [``min``, ``max``]
  ``loguniform``  between ``min`` and ``max``
  ``uniform``     whole numbers from ``min`` to ``max``
  ``fixed``       ``value``
Arrivals are Poisson at ``rate`` (exponential gaps), open loop: a request
is due at its arrival whether or not earlier ones have finished."""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List

import numpy as np


@dataclasses.dataclass
class Item:
    arrival: float          # seconds after the window opens
    prompt: np.ndarray      # int32 token ids
    max_new_tokens: int


def quantile(dist: dict, u: float) -> float:
    kind = dist["dist"]
    if kind == "lognormal":
        x = dist["median"] * math.exp(
            dist["sigma"] * statistics.NormalDist().inv_cdf(u))
    elif kind == "loguniform":
        x = dist["min"] * (dist["max"] / dist["min"]) ** u
    elif kind == "uniform":
        x = dist["min"] + math.floor(u * (dist["max"] - dist["min"] + 1))
    elif kind == "fixed":
        x = dist["value"]
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    lo, hi = dist.get("min", x), dist.get("max", x)
    return min(max(x, lo), hi)


def sizes(dist: dict, n: int) -> List[int]:
    return [int(round(quantile(dist, (i + 0.5) / n))) for i in range(n)]


def requests(mix: dict, seed: int, seconds: float, vocab: int,
             rate: float = None) -> List[Item]:
    """The window's requests, in arrival order."""
    rate = mix["rate"] if rate is None else rate
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng([int(seed), 7])
    prompts = rng.permutation(sizes(mix["prompt"], n))
    outputs = rng.permutation(sizes(mix["output"], n))
    gaps = rng.permutation([-math.log(1.0 - (i + 0.5) / n) / rate
                            for i in range(n)])
    arrivals = np.cumsum(gaps) - gaps[0]          # the first at 0
    out = []
    for a, p, o in zip(arrivals, prompts, outputs):
        if a >= seconds:
            break
        out.append(Item(float(a), rng.integers(0, vocab, int(p),
                                               dtype=np.int32), int(o)))
    return out
