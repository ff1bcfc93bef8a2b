"""Discrete-event distributed-execution simulator (the repo's fabric truth).

Predicts per-step wall-clock time for a mapped application:

  ``topology``     hierarchical alpha-beta network from a MachineSpec
                   (per-level latency/bandwidth, port contention;
                   stride-arithmetic routing + bucketed vectorized
                   pricing, no processor-count ceiling)
  ``collectives``  wire schedules for the patterns the nine apps emit,
                   derived from the exact tile->processor assignment
                   (packed tile-space tensors, memoized expansion)
  ``engine``       event-queue execution of compute segments overlapped
                   with comm streams, Backpressure = in-flight depth
  ``batch``        analytic-envelope engine pricing whole candidate
                   beams in one candidates x phases x ports pass
  ``torch_backend`` TorchBatchSimulator: the batch engine's pricing as
                   tensor programs on the card, its per-level
                   congestion reduction through the hand-written
                   ``segment_rowmax`` kernel
  ``cost``         SimulatedTimeCostModel: the simulator behind the
                   CostModel protocol, so the tuner optimizes seconds

The counterpart of ``repro.sim``: every module but ``torch_backend`` is
a copy of the NumPy original. ``machine.modeled_step_time`` remains the
flat-topology fast path.
"""
from repro_torch.sim.batch import BatchSimulator, batch_simulator, canonical_assignment
from repro_torch.sim.collectives import (
    CollectivePattern,
    PackedSchedule,
    Phase,
    build_phases,
    packed_schedule,
)
from repro_torch.sim.cost import (
    SimReport,
    SimulatedTimeCostModel,
    simulate_app,
    spec_for,
    time_search_space,
    time_tuned_app,
)
from repro_torch.sim.engine import Timeline, simulate_steps, simulate_tasks
from repro_torch.sim.topology import Topology

__all__ = [
    "BatchSimulator",
    "CollectivePattern",
    "PackedSchedule",
    "Phase",
    "SimReport",
    "SimulatedTimeCostModel",
    "Timeline",
    "Topology",
    "batch_simulator",
    "build_phases",
    "canonical_assignment",
    "packed_schedule",
    "simulate_app",
    "simulate_steps",
    "simulate_tasks",
    "spec_for",
    "time_search_space",
    "time_tuned_app",
]
