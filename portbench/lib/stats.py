"""The arithmetic of the end-to-end metrics."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """Nearest-rank q-th percentile (0 < q <= 100). A request that did not
    finish is given as math.inf and counts as a miss; an empty sample is
    math.inf."""
    xs = sorted(values)
    if not xs:
        return math.inf
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def rate(amounts_at, t0: float, t1: float) -> float:
    """The work handed back in [t0, t1] over the whole window: amounts_at
    is [(time it was handed back, amount)]; work outside the window counts
    for nothing."""
    if t1 <= t0:
        raise ValueError("an empty window")
    return sum(a for t, a in amounts_at if t0 <= t <= t1) / (t1 - t0)
