"""The arithmetic of the end-to-end metrics: exact percentiles over every
sample, rates over a whole window, and busy time as the union of
intervals (intervals that overlap, as kernels on two streams do, are
counted once)."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of every value, by linear
    interpolation between the two nearest ranks (numpy's default rule).
    Raises on no values: a tail of nothing is not a number."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(units: float, t_start: float, t_end: float) -> float:
    """Units per second over the whole span from ``t_start`` to ``t_end``."""
    span = t_end - t_start
    if span <= 0:
        raise ValueError("empty span")
    return units / span


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering exactly what ``intervals`` do."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(e - s for s, e in merge(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle gaps inside [lo, hi]: what the union leaves uncovered."""
    out, t = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med
