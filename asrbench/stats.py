"""Percentiles and spreads, as the benchmark's bounds use them."""

from __future__ import annotations

import math
import statistics

BEYOND = 10   # requests a reported percentile needs beyond it


def percentile(values: list[float], p: float) -> float:
    """The p-th percentile (linear between order statistics). Refuses a
    sample with fewer than BEYOND values beyond it; a failed request is
    inf and counts as missing every limit."""
    n = len(values)
    if n * (100.0 - p) / 100.0 < BEYOND:
        raise ValueError(f"p{p:g} of {n} requests has fewer than {BEYOND} beyond it")
    xs = sorted(values)
    k = (n - 1) * p / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, n - 1)
    if math.isinf(xs[hi]):
        return xs[hi]
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def spread(values: list[float]) -> float:
    """The distance between the first and third quartiles over the median
    (statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
