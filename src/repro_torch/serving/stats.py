"""Shared serving metrics: the percentile math.

:func:`percentile` is the one latency-quantile implementation of the
serving layer (a copy of ``repro.serving.stats``'s): the nearest-rank
estimator, deterministic, exact at tiny sample counts and monotone in
``q``. The tuning service's ``ServiceStats`` comes with the mapping
service's slice of the port.
"""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of ``values`` (unsorted ok).

    ``q`` is in percent (0..100). Empty input returns 0.0; a single
    sample is every percentile of itself; with two samples the median
    is the lower one and p95/p99 the upper (rank ``ceil(q/100 * n)``,
    1-based, clamped into the sample).
    """
    if not 0 <= q <= 100:
        raise ValueError(f"q must be in [0, 100], got {q}")
    data = sorted(values)
    if not data:
        return 0.0
    rank = max(math.ceil(q / 100.0 * len(data)), 1)
    return data[min(rank, len(data)) - 1]


def latency_summary(latencies: Sequence[float],
                    prefix: str = "") -> dict[str, float]:
    """The standard p50/p95/p99 block, keys optionally prefixed."""
    return {
        f"{prefix}p50_s": percentile(latencies, 50),
        f"{prefix}p95_s": percentile(latencies, 95),
        f"{prefix}p99_s": percentile(latencies, 99),
    }


__all__ = ["latency_summary", "percentile"]
