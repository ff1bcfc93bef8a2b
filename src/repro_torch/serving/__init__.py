"""Serving layer of the port: the LM continuous-batching scheduler.

:class:`ContinuousBatcher` is the inference-side slot scheduler (decode
lockstep over a fixed cache pool); it reports latencies through
:func:`percentile` in :mod:`repro_torch.serving.stats`. The mapping
service and its plan cache come with their own slice of the port.
"""
from repro_torch.serving.scheduler import ContinuousBatcher, Request, ServeStats
from repro_torch.serving.stats import latency_summary, percentile

__all__ = [
    "ContinuousBatcher",
    "Request",
    "ServeStats",
    "latency_summary",
    "percentile",
]
