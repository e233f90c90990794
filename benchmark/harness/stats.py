"""The arithmetic of the end-to-end metrics and of the bounds."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, linear between the two nearest
    ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window: all the work over all the time."""
    if seconds <= 0:
        raise ValueError("no time measured")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median, the quartiles as statistics.quantiles(values, n=4) gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
