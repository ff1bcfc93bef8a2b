"""Fault-aware remapping: recover a tuned mapping after machine failures.

When processors die mid-run, the healthy plan is unusable — its placement
puts tiles on processors that no longer exist — but re-tuning from
scratch prices thousands of analytic points before the beam even forms.
:func:`remap_plan` is the fast middle path:

1. **Survivor selection**: fold the failures into a
   :class:`~repro_torch.core.machine.DegradedMachine` and pick the regular
   sub-machine (``a' nodes x g' procs``) that keeps the most usable
   processors while remaining feasible for the application's search
   space (:func:`submachine_options` ranks every choice).
2. **Warm, restricted search**: tune on the sub-machine shape, seeding
   the beam with the stale winner (and any plan-cache neighbours) refit
   via :func:`~repro_torch.search.tuner.refit_candidate`, and — in ``"warm"``
   mode — restricting Phase 1 to those seeded points
   (``prepare_tune(restrict=...)``), so recovery latency is a handful
   of pricings instead of a full enumeration. Surviving port contention
   is translated onto the sub-machine so the search prices what the
   survivors will actually feel.
3. **Physical translation + audit**: the winner's logical placement is
   mapped through ``proc_map`` onto the surviving physical processors
   (never a dead one, by construction) and priced on the *original*
   degraded machine, next to the stale placement (``inf`` when it
   touches a dead processor) — the recovery-quality numbers a
   resilience benchmark gates on.

The counterpart of ``repro.search.remap``. Phase 3 pricing runs on the
engine the caller names (``"batched-torch"`` prices on ``device``); the
audit of step 3 is the NumPy :class:`~repro_torch.sim.batch.BatchSimulator`
on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator

import numpy as np

from repro_torch.core.machine import DegradedMachine, MachineSpec
from repro_torch.search.pipeline import price_jobs
from repro_torch.search.space import Candidate, build_program
from repro_torch.search.tuner import (
    DEFAULT_BEAM,
    DEFAULT_LEADERBOARD,
    TuningReport,
    prepare_tune,
    refit_candidate,
)
from repro_torch.sim.batch import BatchSimulator
from repro_torch.sim.collectives import packed_schedule
from repro_torch.sim.cost import (
    DEFAULT_ELEM_BYTES,
    DEFAULT_STEPS,
    pattern_with_options,
    spec_for,
    time_tuned_app,
)
from repro_torch.sim.topology import Topology

#: Ranked sub-machine choices examined before concluding no surviving
#: regular grid can host the application.
MAX_SUBMACHINE_TRIES = 64


# ------------------------------------------------------------------ failures
def degraded_from_failures(spec: MachineSpec, failures) -> DegradedMachine:
    """Fold heterogeneous failure evidence into one degraded view.

    Accepts a ready :class:`DegradedMachine`, a single failure, or an
    iterable mixing: ``DegradedMachine`` views (merged), objects with a
    ``.procs`` tuple (``sim.engine.NodeFailure``, node-death
    ``FaultEvent``), and bare processor ids. Transient link-slowdown
    events are skipped — they are weather, not a persistent machine
    state to remap around.
    """
    if isinstance(failures, DegradedMachine):
        if failures.spec != spec:
            raise ValueError(
                "degraded view describes a different machine than spec")
        return failures
    if not isinstance(failures, (list, tuple, set, frozenset)):
        failures = (failures,)
    view = DegradedMachine.healthy(spec)
    dead: list[int] = []
    for item in failures:
        if isinstance(item, DegradedMachine):
            view = view.merged(item)
        elif hasattr(item, "procs"):
            if getattr(item, "kind", "node-death") != "node-death":
                continue
            dead.extend(int(p) for p in item.procs)
        else:
            dead.append(int(item))
    if dead:
        view = view.merged(DegradedMachine.fail_procs(spec, dead))
    return view


# ------------------------------------------------------------ survivor grids
def submachine_options(degraded: DegradedMachine
                       ) -> Iterator[tuple[tuple[int, int], tuple[int, ...]]]:
    """Regular ``(a', g')`` sub-machines of the survivors, best first.

    Yields ``(sub_shape, proc_map)`` pairs: ``proc_map[j]`` is the
    physical processor hosting logical processor ``j`` of the
    sub-machine (node-major, so logical node ``i'`` occupies ``g'``
    alive slots of one physical node — level-0 crossings on the
    sub-machine are level-0 crossings on the real one). Ranked by
    usable processors, ties toward more processors per node (cheaper
    intra-node traffic)."""
    spec = degraded.spec
    if len(spec.shape) != 2:
        raise ValueError(
            f"remap supports (nodes, procs) machines, got shape {spec.shape}")
    nodes, gpus = (int(s) for s in spec.shape)
    dead = set(degraded.dead_procs)
    avail = [[g for g in range(gpus) if i * gpus + g not in dead]
             for i in range(nodes)]
    options: list[tuple[int, int, int]] = []
    for g in range(1, gpus + 1):
        a_max = sum(1 for row in avail if len(row) >= g)
        for a in range(a_max, 0, -1):
            options.append((a * g, g, a))
    options.sort(key=lambda t: (-t[0], -t[1]))
    for _n, g, a in options:
        ok = [i for i in range(nodes) if len(avail[i]) >= g][:a]
        pm = tuple(i * gpus + avail[i][k] for i in ok for k in range(g))
        yield (a, g), pm


def _mapped_degradation(degraded: DegradedMachine,
                        sub_shape: tuple[int, int],
                        proc_map: tuple[int, ...]) -> DegradedMachine | None:
    """The surviving port contention, seen from the sub-machine.

    Every logical node is one physical node, so the sub-machine's
    level-0 port ``i'`` drains through exactly the physical NIC of
    ``proc_map[i' * g']``'s node; level-1 (per-processor) ports map
    one-to-one through ``proc_map``. Dead processors never appear —
    the sub-machine is built from survivors only."""
    if degraded.contention is None:
        return None
    gpus = int(degraded.spec.shape[1])
    a, g = sub_shape
    row0 = tuple(degraded.contention[0][proc_map[i * g] // gpus]
                 for i in range(a))
    row1 = tuple(degraded.contention[1][p] for p in proc_map)
    view = DegradedMachine(spec=spec_for(sub_shape),
                           contention=(row0, row1))
    return None if view.is_trivial else view


# ----------------------------------------------------------------- utilities
def _candidate_of(plan) -> Candidate | None:
    """A ``Candidate`` from whatever shape a 'plan' arrives in —
    ``Candidate``, ``ScoredCandidate``, ``TuningReport``, a service
    ``MappingPlan`` or its JSON payload; ``None`` when unrecognizable."""
    if plan is None:
        return None
    if isinstance(plan, Candidate):
        return plan
    best = getattr(plan, "best", None)          # TuningReport
    if best is not None:
        plan = best
    cand = getattr(plan, "candidate", None)     # ScoredCandidate/MappingPlan
    if isinstance(cand, Candidate):
        return cand
    payload = None
    if isinstance(cand, dict):
        payload = cand
    elif isinstance(plan, dict):
        payload = plan.get("candidate", plan)
    if not isinstance(payload, dict):
        return None
    try:
        return Candidate(
            grid=tuple(int(g) for g in payload["grid"]),
            dist=tuple(str(d) for d in payload["dist"]),
            order=tuple(int(o) for o in payload["order"]),
            options=tuple((str(k), str(v)) for k, v in payload["options"]),
        )
    except (KeyError, TypeError, ValueError):
        return None


def price_on_degraded(app, degraded: DegradedMachine, candidate: Candidate,
                      placement, *, procs: int, steps: int = DEFAULT_STEPS,
                      elem_bytes: int = DEFAULT_ELEM_BYTES,
                      backpressure: int = 2) -> float:
    """Seconds per step of a *physical* placement on the degraded
    machine — ``inf`` when the placement touches a dead processor
    (a stale plan after a node death is not slow, it is impossible).
    ``procs`` is the number of processors doing the compute leg."""
    pattern = getattr(app, "collective", None)
    if pattern is None:
        raise ValueError(f"application {app.name!r} declares no collective")
    flat = np.asarray(placement, dtype=np.int64).reshape(1, -1)
    dead = set(degraded.dead_procs)
    if dead and dead.intersection(int(p) for p in flat[0]):
        return float("inf")
    spec = degraded.spec
    sim = BatchSimulator(
        topology=Topology.from_spec(spec, degraded=degraded),
        schedule=packed_schedule(
            pattern_with_options(pattern, dict(candidate.options)),
            tuple(int(g) for g in candidate.grid), elem_bytes=elem_bytes),
        compute_s=float(app.step_flops(procs)) / (procs * spec.peak_flops),
        backpressure=backpressure,
        steps=steps,
    )
    # fold=False: physical placements are injective into the full machine
    # but not bijective, and correctness beats the folding speedup for a
    # single audit pricing.
    return float(sim.step_times(flat, fold=False)[0])


# -------------------------------------------------------------------- result
@dataclasses.dataclass(frozen=True)
class RemapResult:
    """A recovered mapping plus its recovery-quality audit numbers."""

    app: str
    degraded: DegradedMachine
    sub_shape: tuple[int, int]
    #: ``proc_map[j]`` = physical processor of logical processor ``j``.
    proc_map: tuple[int, ...]
    procs: int                       # processors the remapped plan uses
    report: TuningReport             # the (restricted) search's full report
    #: Physical tile->processor grid; values index the ORIGINAL machine
    #: and never include a dead processor.
    placement: np.ndarray
    degraded_step_s: float           # remapped plan on the degraded machine
    stale_step_s: float              # old placement there (inf if impossible)
    mode: str                        # "warm" | "cold"
    elapsed_s: float

    @property
    def n_alive(self) -> int:
        return self.degraded.n_alive

    def summary(self) -> dict:
        best = self.report.best.candidate
        return {
            "app": self.app,
            "mode": self.mode,
            "n_alive": self.n_alive,
            "procs": int(self.procs),
            "sub_shape": list(self.sub_shape),
            "proc_map": [int(p) for p in self.proc_map],
            "grid": list(best.grid),
            "options": [[k, v] for k, v in best.options],
            "placement": self.placement.tolist(),
            "degraded_step_s": self.degraded_step_s,
            "stale_step_s": self.stale_step_s,
            "elapsed_s": self.elapsed_s,
        }


# ---------------------------------------------------------------------- core
def remap_plan(app, plan, failures, *, seeds: Iterable = (),
               mode: str = "warm", engine: str = "batched",
               dtype: str = "float64", cache=None, beam: int = DEFAULT_BEAM,
               leaderboard: int = DEFAULT_LEADERBOARD,
               steps: int = DEFAULT_STEPS,
               elem_bytes: int = DEFAULT_ELEM_BYTES,
               procs: int | None = None,
               device: str = "cuda") -> RemapResult:
    """Warm-start a tuned plan onto the processors that survived.

    ``plan`` is the stale winner in any shape :func:`_candidate_of`
    understands (or ``None``); ``failures`` is anything
    :func:`degraded_from_failures` accepts; ``seeds`` adds plan-cache
    neighbours to the warm beam. ``mode="warm"`` restricts Phase 1 to
    the seeded points (the fast path), ``mode="cold"`` runs the full
    enumeration on the sub-machine — the baseline the resilience
    benchmark compares recovery latency against. Both modes search with
    surviving contention mapped onto the sub-machine and return the
    physically-translated placement audited on the original degraded
    machine. ``device`` is where the ``"batched-torch"`` engine prices
    (ignored by the host engines)."""
    t0 = time.perf_counter()
    if mode not in ("warm", "cold"):
        raise ValueError(f"mode must be 'warm' or 'cold', got {mode!r}")
    base_space = app.search_space
    if base_space is None:
        raise ValueError(f"application {app.name!r} declares no search space")
    n0 = app.procs(procs)
    if not base_space.grids(n0):
        n0 = app.default_procs
    shape0 = tuple(int(s) for s in app.machine_shape(n0))
    spec0 = spec_for(shape0)
    degraded = degraded_from_failures(spec0, failures)

    plan_cand = _candidate_of(plan)
    seed_cands = [plan_cand] if plan_cand is not None else []
    seed_cands += [c for c in (_candidate_of(s) for s in seeds)
                   if c is not None]

    chosen = None
    last_err: Exception | None = None
    for tried, (sub_shape, proc_map) in enumerate(
            submachine_options(degraded)):
        if tried >= MAX_SUBMACHINE_TRIES:
            break
        n = sub_shape[0] * sub_shape[1]
        if not base_space.grids(n):
            continue
        app_sub = dataclasses.replace(
            app, machine_shape=lambda p, s=sub_shape: s)
        mapped = _mapped_degradation(degraded, sub_shape, proc_map)
        tuned = time_tuned_app(app_sub, steps=steps, elem_bytes=elem_bytes,
                               engine=engine, dtype=dtype, device=device,
                               cache=cache, degraded=mapped)
        space_t = tuned.search_space
        refit = [r for r in (refit_candidate(space_t, c, n)
                             for c in seed_cands) if r is not None]
        try:
            pending = prepare_tune(
                tuned, n, beam=beam, leaderboard=leaderboard,
                warm_start=refit,
                restrict=(refit or None) if mode == "warm" else None)
            if pending.n != n:
                # The tuner's own infeasibility fallback kicked in —
                # this sub-machine cannot host the app at scale n.
                continue
            price_jobs(list(pending.jobs()))
            report = pending.finish()
        except ValueError as exc:
            last_err = exc
            continue
        chosen = (sub_shape, proc_map, n, report)
        break
    if chosen is None:
        hint = f" (last error: {last_err})" if last_err is not None else ""
        raise ValueError(
            f"no surviving regular sub-machine of {spec0.shape} can host "
            f"{app.name!r} ({degraded.n_alive} of {spec0.nprocs} processors "
            f"alive){hint}")

    sub_shape, proc_map, n, report = chosen
    best = report.best.candidate
    logical = np.asarray(
        report.best_program.mapper.assignment_grid(best.grid),
        dtype=np.int64)
    physical = np.asarray(proc_map, dtype=np.int64)[logical]
    degraded_step_s = price_on_degraded(
        app, degraded, best, physical, procs=n, steps=steps,
        elem_bytes=elem_bytes)

    stale_step_s = float("inf")
    if plan_cand is not None:
        try:
            prog0 = build_program(shape0, plan_cand, f"{app.name}_stale")
            assign0 = prog0.mapper.assignment_grid(plan_cand.grid,
                                                   use_cache=False)
            stale_step_s = price_on_degraded(
                app, degraded, plan_cand, assign0, procs=n0, steps=steps,
                elem_bytes=elem_bytes)
        except (ValueError, KeyError):
            stale_step_s = float("inf")

    return RemapResult(
        app=app.name,
        degraded=degraded,
        sub_shape=sub_shape,
        proc_map=tuple(int(p) for p in proc_map),
        procs=n,
        report=report,
        placement=physical,
        degraded_step_s=degraded_step_s,
        stale_step_s=stale_step_s,
        mode=mode,
        elapsed_s=time.perf_counter() - t0,
    )


__all__ = [
    "MAX_SUBMACHINE_TRIES",
    "RemapResult",
    "degraded_from_failures",
    "price_on_degraded",
    "remap_plan",
    "submachine_options",
]
