"""Runtime resilience: failures, stragglers, elastic, compression."""
from repro_torch.runtime.resilience import (
    FailureInjector, SimulatedFailure, StragglerMonitor, Supervisor, elastic_plan,
)
from repro_torch.runtime import compression

__all__ = ["FailureInjector", "SimulatedFailure", "StragglerMonitor",
           "Supervisor", "compression", "elastic_plan"]
