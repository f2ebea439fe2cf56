"""Order statistics the harness reports."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest rank of the sorted
    values; inf counts as a value (a request that never came)."""
    v = sorted(values)
    if not v:
        return math.nan
    rank = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[rank - 1])


def spread(values) -> float:
    """Inter-quartile range over the median (statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
