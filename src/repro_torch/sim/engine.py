"""Discrete-event engine: compute segments overlapped with comm streams.

The unit of simulation is a *task* — a segment of known duration bound to
one serial resource (the lockstep SPMD ``compute`` stream or the shared
``network`` stream) with dependency edges. A heap-based event queue pops
the earliest completion, marks dependents ready, and dispatches every
ready task whose resource is free; ties resolve deterministically by task
key, so a simulation is a pure function of its inputs.

:func:`simulate_steps` builds the step-loop task graph for an application:

  * ``compute[s]`` depends on ``compute[s-1]`` (one accelerator stream) and
    on ``comm[s - backpressure]`` completing — the ``Backpressure``
    directive realized exactly as the training loop realizes it: at most
    ``backpressure`` steps may be in flight before dispatch blocks on the
    oldest step's completion;
  * ``comm[s][p]`` (phase ``p`` of step ``s``) depends on ``comm[s][p-1]``
    and, for the first phase, on ``compute[s]``; all comm segments share
    the serial ``network`` resource, so communication of step ``s``
    overlaps compute of steps ``s+1 .. s+backpressure-1``.

Phase durations come from :meth:`Topology.phase_time`, i.e. they carry the
exact port-contention cost of the tile->processor placement.

:func:`simulate_steps_with_faults` runs the same step loop under a fault
schedule (:class:`FaultEvent`): transient link slowdowns re-price the
phases dispatched inside their window on a contended
:class:`~repro_torch.core.machine.DegradedMachine` view, and a node death that
intersects the placement halts the run at the death timestamp with a
typed :class:`NodeFailure` outcome — never a silently wrong timeline.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Hashable, Sequence

from repro_torch.core.machine import DegradedMachine
from repro_torch.sim.collectives import Phase
from repro_torch.sim.topology import Topology

COMPUTE = "compute"
NETWORK = "network"

FAULT_KINDS = ("node-death", "link-slowdown")


@dataclasses.dataclass(frozen=True)
class Task:
    """One schedulable segment: fixed duration on a serial resource."""

    key: Hashable
    duration: float
    resource: str
    deps: tuple[Hashable, ...] = ()
    step: int = -1
    label: str = ""


@dataclasses.dataclass(frozen=True)
class Segment:
    """One executed task on the timeline."""

    key: Hashable
    resource: str
    start: float
    end: float
    step: int
    label: str

    def row(self) -> dict:
        return {
            "resource": self.resource,
            "step": self.step,
            "label": self.label,
            "start": self.start,
            "end": self.end,
        }


@dataclasses.dataclass
class Timeline:
    """The executed schedule: segments plus derived step metrics."""

    segments: list[Segment]
    makespan: float
    steps: int

    def step_interval(self, step: int) -> tuple[float, float]:
        segs = [s for s in self.segments if s.step == step]
        return (min(s.start for s in segs), max(s.end for s in segs))

    @property
    def max_in_flight(self) -> int:
        """Peak number of steps simultaneously active (dispatched, not yet
        fully retired) — the quantity ``Backpressure`` bounds."""
        events: list[tuple[float, int]] = []
        for s in range(self.steps):
            t0, t1 = self.step_interval(s)
            events.append((t0, 1))
            events.append((t1, -1))
        peak = cur = 0
        # Retirements at time t free a slot before dispatches at time t.
        for _, delta in sorted(events, key=lambda e: (e[0], e[1])):
            cur += delta
            peak = max(peak, cur)
        return peak

    def busy(self, resource: str) -> float:
        return sum(s.end - s.start for s in self.segments
                   if s.resource == resource)

    def per_step_time(self) -> float:
        """Steady-state seconds per step: the marginal cost of the last
        step when more than one ran, else the makespan."""
        if self.steps <= 1:
            return self.makespan
        prev_end = self.step_interval(self.steps - 2)[1]
        return max(self.makespan - prev_end, 0.0) or self.makespan / self.steps

    def rows(self) -> list[dict]:
        return [s.row() for s in self.segments]


def _run_tasks(tasks: Sequence[Task],
               duration_fn: "Callable[[Task, float], float] | None" = None,
               halt_at: float | None = None) -> tuple[Timeline, bool]:
    """The event-queue walk behind :func:`simulate_tasks`.

    ``duration_fn(task, now)`` resolves a task's duration at dispatch
    time (fault windows re-price comm phases this way); ``halt_at``
    aborts the walk at a simulated timestamp — in-flight segments are
    clipped there and the truncated timeline returns with ``halted=True``
    instead of the usual cycle check.
    """
    by_key = {t.key: t for t in tasks}
    missing = {d for t in tasks for d in t.deps if d not in by_key}
    if missing:
        raise ValueError(f"tasks depend on unknown keys: {sorted(map(str, missing))}")
    remaining = {t.key: len(t.deps) for t in tasks}
    dependents: dict[Hashable, list[Hashable]] = {}
    for t in tasks:
        for d in t.deps:
            dependents.setdefault(d, []).append(t.key)

    order = {t.key: i for i, t in enumerate(tasks)}   # deterministic ties
    ready: dict[str, list[tuple[int, Hashable]]] = {}
    for t in tasks:
        if remaining[t.key] == 0:
            heapq.heappush(ready.setdefault(t.resource, []),
                           (order[t.key], t.key))

    free_at: dict[str, float] = {}
    events: list[tuple[float, int, Hashable]] = []   # (end, order, key)
    segments: list[Segment] = []
    now = 0.0
    done = 0

    def dispatch() -> None:
        # A resource takes work only when idle, picking the ready task
        # with the lowest creation order — so an earlier step's next phase
        # is never queue-jumped by a later step that became ready while
        # the resource was busy.
        for res, heap in ready.items():
            while heap and free_at.get(res, 0.0) <= now:
                _, key = heapq.heappop(heap)
                t = by_key[key]
                dur = (t.duration if duration_fn is None
                       else float(duration_fn(t, now)))
                end = now + dur
                free_at[res] = end
                segments.append(Segment(key, res, now, end, t.step, t.label))
                heapq.heappush(events, (end, order[key], key))

    dispatch()
    while events:
        now, _, key = heapq.heappop(events)
        if halt_at is not None and now >= halt_at:
            # The fault fires before this completion: clip every
            # in-flight segment at the fault instant and stop.
            clipped = [
                dataclasses.replace(s, end=min(s.end, halt_at))
                for s in segments if s.start < halt_at
            ]
            steps = max((t.step for t in tasks), default=-1) + 1
            return (Timeline(segments=clipped, makespan=halt_at,
                             steps=steps), True)
        done += 1
        for dep_key in dependents.get(key, ()):
            remaining[dep_key] -= 1
            if remaining[dep_key] == 0:
                t = by_key[dep_key]
                heapq.heappush(ready.setdefault(t.resource, []),
                               (order[dep_key], dep_key))
        dispatch()
    if done != len(tasks):
        raise ValueError("dependency cycle: not every task could run")
    makespan = max((s.end for s in segments), default=0.0)
    steps = max((t.step for t in tasks), default=-1) + 1
    return (Timeline(segments=segments, makespan=makespan, steps=steps),
            False)


def simulate_tasks(tasks: Sequence[Task]) -> Timeline:
    """Run the dependency graph through the event queue; returns the
    executed timeline. Deterministic: ready ties dispatch in key order."""
    timeline, _ = _run_tasks(tasks)
    return timeline


def simulate_steps(
    phases: Sequence[Phase],
    topology: Topology,
    *,
    compute_s: float,
    steps: int = 3,
    backpressure: int = 2,
) -> Timeline:
    """Simulate ``steps`` iterations of (compute, comm phases) under the
    in-flight bound. ``phases`` is ONE step's schedule; every step repeats
    it. Phase durations are congestion-priced once (the schedule is
    identical each step) and reused."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if backpressure < 1:
        raise ValueError(f"backpressure must be >= 1, got {backpressure}")
    # The reference engine prices each phase independently — deliberately
    # the simple, legible formulation. The batched engine
    # (repro_torch.sim.batch) prices whole candidate beams in one bucketed pass
    # and is validated against this path to 1e-9.
    durations = [
        topology.phase_time(ph.src, ph.dst, ph.nbytes) for ph in phases
    ]
    tasks: list[Task] = []
    for s in range(steps):
        deps: list[Hashable] = []
        if s > 0:
            deps.append(("compute", s - 1))
        gate = s - backpressure
        if gate >= 0:
            deps.append(("comm_done", gate))
        tasks.append(Task(
            key=("compute", s), duration=compute_s, resource=COMPUTE,
            deps=tuple(deps), step=s, label="compute",
        ))
        prev: Hashable = ("compute", s)
        for p, (ph, dur) in enumerate(zip(phases, durations)):
            key = ("comm", s, p)
            tasks.append(Task(
                key=key, duration=dur, resource=NETWORK, deps=(prev,),
                step=s, label=ph.label,
            ))
            prev = key
        # Zero-duration completion marker so the backpressure gate has a
        # single key whether or not the step communicates.
        tasks.append(Task(
            key=("comm_done", s), duration=0.0, resource=NETWORK,
            deps=(prev,), step=s, label="step_done",
        ))
    return simulate_tasks(tasks)


# ------------------------------------------------------------------- faults
@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault at simulated time ``t``.

    ``kind="node-death"``: the processors in ``procs`` die permanently at
    ``t``. A run whose placement uses any of them halts there with a
    :class:`NodeFailure`; a run that never touches them is unaffected.

    ``kind="link-slowdown"``: background traffic steals bandwidth at one
    machine level for ``duration`` seconds — every port in ``ports``
    (``None`` = all of the level's ports) drains bytes ``factor`` times
    slower. Comm phases *dispatched* inside the window pay the contended
    price for their whole transfer (dispatch-time resolution — the
    engine's serial network stream never preempts a running phase).
    """

    t: float
    kind: str
    procs: tuple[int, ...] = ()
    level: int = 0
    factor: float = 1.0
    duration: float = float("inf")
    ports: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}"
            )
        if self.t < 0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.kind == "node-death" and not self.procs:
            raise ValueError("node-death needs at least one processor")
        if self.kind == "link-slowdown":
            if self.factor < 1.0:
                raise ValueError(
                    f"slowdown factor must be >= 1.0, got {self.factor}"
                )
            if self.duration <= 0:
                raise ValueError(
                    f"slowdown duration must be > 0, got {self.duration}"
                )
        object.__setattr__(self, "procs",
                           tuple(sorted({int(p) for p in self.procs})))


@dataclasses.dataclass(frozen=True)
class NodeFailure:
    """Typed outcome of a fatal fault: when, during which step, and which
    processors died. Returned instead of a silently wrong timeline."""

    time: float
    step: int
    procs: tuple[int, ...]


@dataclasses.dataclass
class FaultyRun:
    """A step-loop run under fault injection: the (possibly truncated)
    degraded timeline plus the failure that ended it, if any."""

    timeline: Timeline
    failure: NodeFailure | None = None

    @property
    def survived(self) -> bool:
        return self.failure is None

    def per_step_time(self) -> float:
        """Steady-state step time of a surviving run; a failed run has no
        steady state, so this refuses instead of answering wrongly."""
        if self.failure is not None:
            raise ValueError(
                f"run died at t={self.failure.time:.3g}s (step "
                f"{self.failure.step}); a failed run has no step time"
            )
        return self.timeline.per_step_time()


def _window_topology(topology: Topology,
                     active: Sequence[FaultEvent]) -> Topology:
    """The topology as seen inside a set of overlapping slowdown windows:
    the base degraded view (if any) composed with each window's per-port
    contention."""
    spec = topology.spec
    deg = topology.degraded or DegradedMachine.healthy(spec)
    for ev in active:
        ports = (range(spec.level_ports[ev.level]) if ev.ports is None
                 else ev.ports)
        deg = deg.merged(DegradedMachine.contend(
            spec, ev.level, {int(p): float(ev.factor) for p in ports}))
    return Topology.from_spec(spec, alphas=topology.alphas, degraded=deg)


def simulate_steps_with_faults(
    phases: Sequence[Phase],
    topology: Topology,
    *,
    compute_s: float,
    steps: int = 3,
    backpressure: int = 2,
    faults: Sequence[FaultEvent] = (),
    placement: Sequence[int] | None = None,
) -> FaultyRun:
    """:func:`simulate_steps` under a fault schedule.

    Link-slowdown events re-price the phases dispatched inside their
    window on the contended machine view (composed with the topology's
    own static degradation, so a degraded machine can degrade further);
    a node-death event intersecting ``placement`` (every death is fatal
    when no placement is given) halts the run at its timestamp and the
    result carries a typed :class:`NodeFailure`. With no faults the
    timeline is bit-identical to :func:`simulate_steps`.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if backpressure < 1:
        raise ValueError(f"backpressure must be >= 1, got {backpressure}")
    if placement is None:
        used = None
    else:
        flat = (placement.reshape(-1).tolist()
                if hasattr(placement, "reshape") else placement)
        used = {int(p) for p in flat}
    halt_at = None
    dead: tuple[int, ...] = ()
    for ev in faults:
        if ev.kind != "node-death":
            continue
        fatal = used is None or used.intersection(ev.procs)
        if fatal and (halt_at is None or ev.t < halt_at):
            halt_at, dead = ev.t, ev.procs
    slowdowns = sorted((ev for ev in faults if ev.kind == "link-slowdown"),
                       key=lambda ev: ev.t)
    base_durations = [
        topology.phase_time(ph.src, ph.dst, ph.nbytes) for ph in phases
    ]
    window_cache: dict[tuple[int, ...], list[float]] = {}

    def priced_in_windows(active: tuple[int, ...]) -> list[float]:
        hit = window_cache.get(active)
        if hit is None:
            topo = _window_topology(topology,
                                    [slowdowns[i] for i in active])
            hit = window_cache[active] = [
                topo.phase_time(ph.src, ph.dst, ph.nbytes) for ph in phases
            ]
        return hit

    def duration_fn(task: Task, now: float) -> float:
        key = task.key
        if not (isinstance(key, tuple) and key and key[0] == "comm"):
            return task.duration
        active = tuple(
            i for i, ev in enumerate(slowdowns)
            if ev.t <= now < ev.t + ev.duration
        )
        if not active:
            return task.duration
        return priced_in_windows(active)[key[2]]

    tasks: list[Task] = []
    for s in range(steps):
        deps: list[Hashable] = []
        if s > 0:
            deps.append(("compute", s - 1))
        gate = s - backpressure
        if gate >= 0:
            deps.append(("comm_done", gate))
        tasks.append(Task(
            key=("compute", s), duration=compute_s, resource=COMPUTE,
            deps=tuple(deps), step=s, label="compute",
        ))
        prev: Hashable = ("compute", s)
        for p, (ph, dur) in enumerate(zip(phases, base_durations)):
            key = ("comm", s, p)
            tasks.append(Task(
                key=key, duration=dur, resource=NETWORK, deps=(prev,),
                step=s, label=ph.label,
            ))
            prev = key
        tasks.append(Task(
            key=("comm_done", s), duration=0.0, resource=NETWORK,
            deps=(prev,), step=s, label="step_done",
        ))
    timeline, halted = _run_tasks(
        tasks,
        duration_fn=duration_fn if slowdowns else None,
        halt_at=halt_at,
    )
    if not halted:
        return FaultyRun(timeline=timeline, failure=None)
    fail_step = max((s.step for s in timeline.segments), default=0)
    return FaultyRun(
        timeline=timeline,
        failure=NodeFailure(time=float(halt_at), step=int(fail_step),
                            procs=dead),
    )


__all__ = [
    "COMPUTE",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultyRun",
    "NETWORK",
    "NodeFailure",
    "Segment",
    "Task",
    "Timeline",
    "simulate_steps",
    "simulate_steps_with_faults",
    "simulate_tasks",
]
