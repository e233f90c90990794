"""Shared order statistics.

One implementation of nearest-rank percentile, used by both the sim's
accounting report and the tracing journey stats — the two surfaces quote
percentiles over the same journeys and must never disagree on rank
rounding.
"""

from __future__ import annotations

import math
from typing import Optional


def percentile(sorted_values: list[float], p: float) -> Optional[float]:
    """Nearest-rank percentile over an ascending list; None when empty."""
    if not sorted_values:
        return None
    rank = max(1, math.ceil(p / 100.0 * len(sorted_values)))
    return sorted_values[rank - 1]
