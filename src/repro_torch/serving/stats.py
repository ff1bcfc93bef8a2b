"""Shared serving metrics: percentile math + the tuning service's stats.

:func:`percentile` is the one latency-quantile implementation both
serving stats surfaces use — :class:`~repro_torch.serving.scheduler.ServeStats`
(the continuous-batching scheduler) and :class:`ServiceStats` (the
mapping-as-a-service tuning server, :mod:`repro_torch.serving.mapsvc`). It is
the nearest-rank estimator: deterministic, exact at tiny sample counts
(0, 1 and 2 samples are unit-tested), and monotone in ``q``.

:class:`ServiceStats` aggregates one service instance's lifetime:
request/served/shed counts by outcome, plan-cache hit vs warm vs cold
search provenance, per-stage timings (admission wait, cache lookup,
search), and end-to-end latencies. ``summary()`` is the JSON metrics
surface (requests/sec, p50/p95/p99) the CLI emits.

The counterpart of ``repro.serving.stats``.
"""
from __future__ import annotations

import dataclasses
import json
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


@dataclasses.dataclass
class ServiceStats:
    """Lifetime counters + timings of one :class:`MappingService`.

    Mutated only under the service's lock; ``summary()``/``to_json()``
    read a consistent snapshot the same way.
    """

    submitted: int = 0
    completed: int = 0                 # requests resolved with a plan
    #: Typed rejections by reason ("queue-full" | "deadline" |
    #: "timeout" | "error" | "closed").
    rejected: dict = dataclasses.field(default_factory=dict)
    #: Plan provenance of completed requests.
    cache_hits: int = 0                # exact plan-cache hits (no search)
    warm: int = 0                      # searched, seeded from a nearby plan
    cold: int = 0                      # searched from scratch
    #: Requests that rode another in-flight request's search (identical
    #: key coalesced inside one batch) — completed, but searched 0 times.
    coalesced: int = 0
    #: Searches actually executed (== distinct keys tuned).
    searches: int = 0
    #: Cross-request shared pricing passes (one per drained batch that
    #: had at least one search).
    shared_pricing_passes: int = 0
    #: Failure remaps served (priority RemapRequest resolutions).
    remaps: int = 0
    #: Worker-thread crashes survived: the batch being processed was
    #: requeued (once per ticket) instead of dropped.
    worker_crashes: int = 0
    latencies: list = dataclasses.field(default_factory=list)
    wait_s: list = dataclasses.field(default_factory=list)     # queue time
    cache_s: list = dataclasses.field(default_factory=list)    # lookup time
    search_s: list = dataclasses.field(default_factory=list)   # tune time
    first_submit_t: float | None = None
    last_resolve_t: float | None = None

    # ------------------------------------------------------------- updates
    def note_rejected(self, reason: str) -> None:
        self.rejected[reason] = self.rejected.get(reason, 0) + 1

    @property
    def shed(self) -> int:
        """Requests shed by admission control or deadlines (everything
        rejected for a non-error reason)."""
        return sum(n for reason, n in self.rejected.items()
                   if reason != "error")

    # ------------------------------------------------------------- surface
    def summary(self) -> dict:
        span = 0.0
        if self.first_submit_t is not None and self.last_resolve_t is not None:
            span = max(self.last_resolve_t - self.first_submit_t, 0.0)
        resolved = self.completed + sum(self.rejected.values())
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": dict(self.rejected),
            "shed": self.shed,
            "cache_hits": self.cache_hits,
            "warm": self.warm,
            "cold": self.cold,
            "coalesced": self.coalesced,
            "searches": self.searches,
            "shared_pricing_passes": self.shared_pricing_passes,
            "remaps": self.remaps,
            "worker_crashes": self.worker_crashes,
            "span_s": span,
            "requests_per_s": (resolved / span) if span > 0 else 0.0,
            "latency": latency_summary(self.latencies),
            "stages": {
                "wait": latency_summary(self.wait_s),
                "cache": latency_summary(self.cache_s),
                "search": latency_summary(self.search_s),
            },
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.summary(), indent=indent)


__all__ = ["ServiceStats", "latency_summary", "percentile"]
