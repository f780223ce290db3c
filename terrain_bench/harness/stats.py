"""The arithmetic of the metrics: percentiles, rates and the busy time of a
union of device intervals."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks (numpy's
    default)."""
    if not len(values):
        raise ValueError("no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return count / seconds


def union_busy(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` [(start, end)] clipped to
    [lo, hi]: the time in which at least one of them runs."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(intervals, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi] that no interval covers, in time order."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
