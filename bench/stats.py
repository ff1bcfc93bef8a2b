"""``percentile``: a frozen copy of ``repro_torch.serving.stats.percentile``."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of ``values`` (q in percent): rank
    ceil(q/100 * n), 1-based, clamped into the sample."""
    if not 0 <= q <= 100:
        raise ValueError(f"q must be in [0, 100], got {q}")
    data = sorted(values)
    if not data:
        raise ValueError("percentile of no values")
    rank = max(math.ceil(q / 100.0 * len(data)), 1)
    return data[min(rank, len(data)) - 1]
