"""The arithmetic of the metrics: a rate over all the work and all the
time of a window, a tail over all samples, and the union of device
intervals and the stretches it leaves."""
from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``: the
    smallest value with at least q% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi) that no interval covers."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]

