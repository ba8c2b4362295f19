"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linearly
    interpolated between the closest ranks (numpy's default)."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds
