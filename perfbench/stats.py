"""Order statistics of the benchmark: one definition for every tail."""
from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the sample at or below it, so always a value that
    was measured. None for an empty sample."""
    if not values:
        return None
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
