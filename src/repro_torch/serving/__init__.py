"""Serving layer of the port: continuous batching scheduler + the tuning service.

Two servers live here. :class:`ContinuousBatcher` is the inference-side
slot scheduler (decode lockstep over a fixed cache pool);
:class:`MappingService` is mapping-as-a-service — a persistent,
concurrent tuning server with a cross-process plan cache
(:class:`PlanCache`), warm-started beam search, priority/deadline
admission and cross-request batched pricing (``python -m
repro_torch.serving.serve`` is its CLI), priced on the NumPy engine or
on the card through the ``batched-torch`` engine. Both report latencies
through the shared :func:`percentile` math in
:mod:`repro_torch.serving.stats`. The counterpart of ``repro.serving``.
"""
from repro_torch.serving.mapsvc import (
    MappingPlan,
    MappingService,
    Rejected,
    RemapRequest,
    Ticket,
    TuneRequest,
)
from repro_torch.serving.plan_cache import PlanCache, plan_key
from repro_torch.serving.scheduler import ContinuousBatcher, Request, ServeStats
from repro_torch.serving.stats import ServiceStats, latency_summary, percentile

__all__ = [
    "ContinuousBatcher",
    "MappingPlan",
    "MappingService",
    "PlanCache",
    "Rejected",
    "RemapRequest",
    "Request",
    "ServeStats",
    "ServiceStats",
    "Ticket",
    "TuneRequest",
    "latency_summary",
    "percentile",
    "plan_key",
]
