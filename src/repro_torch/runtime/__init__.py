"""Runtime resilience: failures, stragglers, elastic re-planning.

The counterpart of ``repro.runtime``, resilience only: gradient
compression comes with the training slice of the port.
"""
from repro_torch.runtime.resilience import (
    FailureInjector, SimulatedFailure, StragglerMonitor, Supervisor, elastic_plan,
)

__all__ = ["FailureInjector", "SimulatedFailure", "StragglerMonitor",
           "Supervisor", "elastic_plan"]
