"""The arithmetic of the end-to-end numbers."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank `q`-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it.  A missing value
    (a failed call) is math.inf, so it lies beyond any limit."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[max(0, math.ceil(q / 100 * len(vals)) - 1)]

