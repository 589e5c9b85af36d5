"""Frame statistics of a window and the run-to-run spread.

A window is a closed loop of whole frames: frame i starts when frame i - 1
is back on the host, frames start until the window's length has passed,
and the last one completes and counts.
"""
from __future__ import annotations

import math
import statistics


def window_mean(start: float, end: float, frames: int) -> float:
    """Seconds a frame over the window: from the first frame's start to the
    last one's end, over the frames completed."""
    if frames < 1:
        raise ValueError("a window completes at least one frame")
    return (end - start) / frames


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) of all values by nearest rank:
    the smallest value with at least q% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median (Python's statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
