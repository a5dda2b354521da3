"""Order statistics and rates, as the benchmark reports them."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) with linear interpolation between the
    closest ranks (numpy's default method). ``inf`` entries stand for
    requests that never completed and sort last."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = q / 100.0 * (len(xs) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: Sequence[float]) -> Optional[float]:
    return percentile(values, 50.0) if values else None


def rate(count: float, seconds: float) -> float:
    """Work per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds
