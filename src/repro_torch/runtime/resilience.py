"""Fault tolerance + straggler mitigation + elastic rescale (simulated).

At 1000+ nodes the mean time between failures is hours, so the framework
treats failure as the steady state:

  * :class:`FailureInjector` — deterministic simulated faults for tests
    (the CPU container has no real nodes to kill);
  * :class:`Supervisor` — the restart policy: catch step failure, restore
    the latest checkpoint, rebuild the step function, continue;
  * :class:`StragglerMonitor` — per-step timing watermarks; flags replicas
    whose EMA exceeds a p95-based threshold and emits a mitigation plan
    (bounded async dispatch already softens transient stragglers — the
    paper's Backpressure directive, repurposed);
  * :func:`elastic_plan` — given the surviving chip count, re-run the
    Mapple decompose planner and emit the (mesh, resharding) plan; combined
    with the mesh-agnostic checkpoints this is restore-with-new-plan.

The counterpart of ``repro.runtime.resilience``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises SimulatedFailure at the scheduled steps (deterministic).

    Each scheduled step fires **at most once**: after a restore rewinds
    the loop past an already-fired step, re-executing it must not
    re-raise — a real node dies once, and the re-fire would burn one
    restart per replay until ``max_restarts`` was exhausted."""

    fail_at_steps: tuple[int, ...] = ()
    max_failures: int = 1_000_000
    fired: int = 0
    fired_steps: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if (self.fired < self.max_failures and step in self.fail_at_steps
                and step not in self.fired_steps):
            self.fired_steps.add(step)
            self.fired += 1
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class Supervisor:
    """Restart-from-checkpoint policy around a step function."""

    checkpoint_manager: Any
    max_restarts: int = 3
    restarts: int = 0

    def run(self, *, state, start_step: int, n_steps: int,
            step_fn: Callable[[int, Any], Any],
            save_every: int, extra: dict | None = None,
            injector: FailureInjector | None = None,
            remap_fn: Callable[[Exception], Any] | None = None):
        """Drives the loop; on failure restores the latest checkpoint and
        resumes. Returns (final_state, history).

        ``remap_fn`` makes the restart *fault-aware*: called with the
        failure before each restore, it may return a remap plan (e.g.
        :func:`elastic_plan`'s output, or a
        :class:`~repro_torch.serving.mapsvc.RemapRequest` resolution). A dict
        plan whose ``"step_fn"`` entry is callable swaps the step
        function — restore-with-new-placement — and the plan (minus the
        callable) is recorded in the history as a ``remapped`` event.
        Returning ``None`` keeps the old plan (plain restart)."""
        history: list[dict] = []
        step = start_step
        while step < n_steps:
            try:
                if injector is not None:
                    injector.check(step)
                state, metrics = step_fn(step, state)
                history.append({"step": step, **metrics})
                step += 1
                if step % save_every == 0:
                    self.checkpoint_manager.save(
                        step, state, {"cursor": step, **(extra or {})}
                    )
            except SimulatedFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                if remap_fn is not None:
                    plan = remap_fn(e)
                    if plan is not None:
                        recorded = plan
                        if isinstance(plan, dict):
                            new_fn = plan.get("step_fn")
                            if callable(new_fn):
                                step_fn = new_fn
                            recorded = {k: v for k, v in plan.items()
                                        if k != "step_fn"}
                        history.append({"step": step, "event": "remapped",
                                        "plan": recorded})
                restored = self.checkpoint_manager.latest_step()
                if restored is None:
                    # No checkpoint yet: restart from the initial state.
                    step = start_step
                    history.append({"step": step, "event": f"restart:{e}"})
                    continue
                step, state, _ = self.checkpoint_manager.restore(restored)
                history.append({"step": step, "event": f"restored:{e}"})
        return state, history


@dataclasses.dataclass
class StragglerMonitor:
    """EMA per-replica step times; flags p95 outliers."""

    n_replicas: int
    ema_alpha: float = 0.2
    threshold: float = 1.5          # x median EMA

    def __post_init__(self):
        self.ema = np.zeros(self.n_replicas)
        self.count = 0

    def observe(self, step_times: np.ndarray) -> dict:
        """step_times: per-replica seconds for the last step."""
        if self.count == 0:
            self.ema = step_times.astype(np.float64)
        else:
            self.ema = (
                self.ema_alpha * step_times + (1 - self.ema_alpha) * self.ema
            )
        self.count += 1
        med = float(np.median(self.ema))
        flags = np.where(self.ema > self.threshold * max(med, 1e-9))[0]
        plan = None
        if len(flags):
            plan = {
                "action": "rebalance",
                "slow_replicas": flags.tolist(),
                # bounded async dispatch absorbs transient skew; persistent
                # skew triggers shard reassignment at the next checkpoint.
                "reassign_at_step": self.count + 10,
            }
        return {
            "median_ema": med,
            "max_over_median": float(self.ema.max() / max(med, 1e-9)),
            "stragglers": flags.tolist(),
            "plan": plan,
        }


def elastic_plan(n_chips_surviving: int, workload, *,
                 max_tp: int = 64) -> dict:
    """Re-plan parallelism for the surviving chip count (Mapple decompose).

    workload: repro_torch.core.autosharder.LMWorkload. Returns the new MeshPlan +
    the resharding recipe (restore checkpoint under the new shardings).

    The usable chip count routes through the tuner's feasibility
    machinery: the mesh planner's divisibility constraints become a
    search space (:func:`~repro_torch.core.autosharder.mesh_search_space`) and
    the plan keeps every survivor the space can host — 12 of 16 chips
    stay 12 when ``dp=12`` divides the batch, instead of collapsing to
    the power-of-two 8. When the survivor count itself is infeasible,
    :func:`~repro_torch.search.tuner.nearest_feasible_procs` lands on the
    nearest feasible count that does not exceed the survivors.
    """
    from repro_torch.core.autosharder import mesh_search_space, plan_mesh
    from repro_torch.search.tuner import feasible_procs, nearest_feasible_procs

    space = mesh_search_space(workload, max_tp=max_tp)
    n = max(int(n_chips_surviving), 1)
    if feasible_procs(space, n):
        usable = n
    else:
        near = nearest_feasible_procs(space, n, count=8,
                                      max_delta=max(n - 1, 1))
        usable = next((m for m in near if m <= n), None)
        if usable is None:     # every near-feasible count needs more chips
            usable = next(
                (m for m in range(n - 1, 0, -1) if feasible_procs(space, m)),
                None)
        if usable is None:
            raise ValueError(
                f"no feasible chip count <= {n} for this workload"
            )
    plan = plan_mesh(usable, workload, max_tp=max_tp)
    return {
        "usable_chips": usable,
        "idle_chips": n - usable,
        "mesh": {"data": plan.dp, "model": plan.tp},
        "ep": plan.ep,
        "resharding": "restore latest checkpoint with new param shardings",
        "step_comm_bytes": plan.step_comm_bytes,
    }
