"""Time-domain cost: the simulator packaged as a ``CostModel``.

Two entry points:

  * :func:`simulate_app` — one application's mapped step through the
    full pipeline (``dsl.parse -> Mapper -> translate.to_spmd``), its
    declared :class:`CollectivePattern` expanded against the *exact*
    tile->processor assignment, executed on the event-queue engine. This
    is what ``python -m repro_torch.apps.run --simulate`` prints.

  * :class:`SimulatedTimeCostModel` — the same machinery behind the
    ``CostModel.cost(grid) -> float`` protocol, returning predicted
    seconds per step instead of element counts, so the mapper autotuner
    (``repro_torch.search.tuner``) optimizes simulated time **unchanged**:
    :func:`time_tuned_app` wraps an Application so ``tune_app`` searches
    on seconds. Scoring runs on the batched analytic-envelope engine
    (``repro_torch.sim.batch``, 1e-9-validated against the event queue;
    ``engine="event"`` pins a model to the exact reference), the tuner's
    beam placements price in one grouped pass via :meth:`beam_pricer`,
    volume models stay the validity filter (a grid the volume model
    rejects is never simulated), and ``benchmarks/sim_eval.py`` asserts
    registry-wide that time-optimal winners never regress the Table 2
    volume oracles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.commvolume import CostModel
from repro_torch.core.machine import GPU, DegradedMachine, MachineSpec
from repro_torch.sim.batch import (
    BatchSimulator,
    batch_simulator,
    canonical_assignment,
)
from repro_torch.sim.collectives import (
    CollectivePattern,
    Phase,
    _pattern_key,
    build_phases,
    schedule_transfer_bound,
)
from repro_torch.sim.price_cache import PriceCache, digest
from repro_torch.sim.engine import Timeline, simulate_steps
from repro_torch.sim.topology import Topology

DEFAULT_STEPS = 3
DEFAULT_ELEM_BYTES = 4

# Candidate grids whose packed schedule would exceed this many wire
# transfers are rejected by SimulatedTimeCostModel with ValueError (the
# same channel volume infeasibility uses), so the tuner never pays a
# multi-GB schedule build for a grid that cannot win. 2^23 transfers is
# ~2s of build; every grid of every registry app at <= 1024 procs is
# orders of magnitude below it (max ~1M), so paper-scale behavior is
# unchanged, while a (1, 16384) panel grid (~2.7e8 transfers) is pruned.
MAX_SCHEDULE_TRANSFERS = 1 << 23


def spec_for(machine_shape: Sequence[int], kind: str = GPU) -> MachineSpec:
    """A MachineSpec for an app's ``(nodes, gpus)`` machine policy shape."""
    shape = tuple(int(s) for s in machine_shape)
    names = ("node", "gpu", "lane", "sublane")[: len(shape)]
    if len(names) < len(shape):
        names = tuple(f"l{i}" for i in range(len(shape)))
    return MachineSpec(shape=shape, level_names=tuple(names), kind=kind)


def _node_split(machine_shape: Sequence[int], grid: tuple[int, ...],
                local_axes: Sequence[int] = ()) -> tuple[int, ...] | None:
    """Per-axis node factors for the default placement of ``grid`` on a
    two-level machine.

    Among all divisible ordered factorizations of the node count, prefer
    (in order): the smallest node factor on ``local_axes`` — the axes a
    pattern declares its heavy collective groups run along, which an
    expert mapper keeps on the fast intra-node fabric (e.g. Solomonik's
    ``c`` replication axis, the analogue of placing TP inside a node and
    DP across nodes) — then the minimal cross-node surface, then
    lexicographic order for determinism. Returns ``None`` when the
    machine degenerates to one level or no divisible split exists.
    """
    from repro_torch.core.commvolume import halo_surface_volume
    from repro_torch.core.decompose import enumerate_factorizations

    if len(machine_shape) != 2:
        # Deeper hierarchies take the flat fallback; only the canonical
        # two-level (nodes, gpus) machines get a hierarchical split.
        return None
    nodes, gpus = (int(s) for s in machine_shape)
    if nodes <= 1 or gpus <= 1:
        return None
    best: tuple[tuple, tuple[int, ...]] | None = None
    for nf in enumerate_factorizations(nodes, len(grid)):
        if any(g % f for g, f in zip(grid, nf)):
            continue
        local_pen = 1
        for a in local_axes:
            local_pen *= nf[a]
        key = (local_pen, halo_surface_volume(grid, nf), nf)
        if best is None or key < best[0]:
            best = (key, nf)
    return None if best is None else best[1]


def default_assignment(machine_shape: Sequence[int],
                       grid: Sequence[int],
                       local_axes: Sequence[int] = ()) -> np.ndarray:
    """The default placement of a tile grid on a two-level machine:
    hierarchical block/block (contiguous per-axis blocks per node, blocks
    of the remainder within a node — the Fig. 12 shape the tuner's
    default candidate materializes) when a divisible node split exists,
    flat row-major block otherwise."""
    grid = tuple(int(g) for g in grid)
    coords = np.indices(grid)
    nf = _node_split(machine_shape, grid, local_axes)
    if nf is None:
        return np.arange(int(np.prod(grid)), dtype=np.int64).reshape(grid)
    gpus = int(machine_shape[1])
    gf = tuple(g // f for g, f in zip(grid, nf))
    node = np.zeros(grid, dtype=np.int64)
    gpu = np.zeros(grid, dtype=np.int64)
    for a in range(len(grid)):
        node = node * nf[a] + coords[a] // gf[a]
        gpu = gpu * gf[a] + coords[a] % gf[a]
    return node * gpus + gpu


def pattern_with_options(pattern: CollectivePattern,
                         opts: dict) -> CollectivePattern:
    """Fold tuner option axes into the pattern parameters. Currently the
    only option that changes the wire schedule is circuit's ZCMEM
    placement of the shared charge region, which removes a device round
    trip (the Table 2 discount)."""
    if pattern.kind == "gather_scatter" and opts.get("arg1") == "ZCMEM":
        params = dict(pattern.params)
        params["discount"] = float(params.get("zc_discount", 0.75))
        return CollectivePattern(pattern.kind, params)
    return pattern


def inter_node_fraction(phases: Sequence[Phase], topo: Topology) -> float:
    """Fraction of scheduled wire bytes crossing the outermost level."""
    total = cross = 0.0
    for ph in phases:
        if ph.src.size == 0:
            continue
        levels = topo.crossing_levels(ph.src, ph.dst)
        total += float(ph.nbytes.sum())
        cross += float(ph.nbytes[levels == 0].sum())
    return cross / total if total else 0.0


@dataclasses.dataclass(frozen=True)
class SimulatedTimeCostModel(CostModel):
    """Predicted seconds per step of a candidate grid on a real fabric.

    Drops into every ``CostModel`` consumer unchanged: the tuner's beam
    search, ``decompose.optimal_factorization(objective=...)``, and the
    leaderboards all rank on seconds. ``base`` (the app's volume model)
    is the validity filter — candidates it rejects with ``ValueError``
    are never simulated, keeping the two objectives' feasible sets
    identical. ``assignment_fn`` maps a candidate grid to its
    tile->processor assignment; the default is the tuner's default
    placement on ``spec.shape``.
    """

    pattern: CollectivePattern
    spec: MachineSpec
    step_flops: float
    base: CostModel | None = None
    assignment_fn: Callable[[tuple[int, ...]], np.ndarray] | None = None
    elem_bytes: int = DEFAULT_ELEM_BYTES
    steps: int = DEFAULT_STEPS
    backpressure: int = 2
    #: "batched" NumPy envelope | "batched-torch" device-resident
    #: envelope (same numbers to <=1e-6 relative) | "event" exact queue.
    engine: str = "batched"
    #: Pricing precision of the batched-torch engine ("float64" matches
    #: the NumPy reference under the parity gates; "float32" is the
    #: opt-in lossy mode). Ignored by the host engines.
    dtype: str = "float64"
    #: Where the batched-torch engine prices ("cuda", the default, runs
    #: the hand-written kernels; "cpu" their plain versions). Ignored by
    #: the host engines.
    device: str = "cuda"
    #: Fault state of the machine (dead procs + per-port contention). A
    #: trivial view is normalized to None so a healthy-equivalent model
    #: shares the healthy model's identity, cache tables, and prices
    #: bit for bit.
    degraded: DegradedMachine | None = None
    #: Optional persistent price store (``repro_torch.sim.price_cache``):
    #: placements whose canonical form was ever priced under this model's
    #: table key short-circuit to a dict lookup — across processes.
    #: Excluded from equality/hash (a cache is an accelerator, not part
    #: of the model's identity).
    cache: PriceCache | None = dataclasses.field(
        default=None, compare=False, repr=False)
    name = "simulated_time"

    def __post_init__(self) -> None:
        if self.engine not in ("batched", "batched-torch", "event"):
            raise ValueError(
                f"engine must be 'batched', 'batched-torch' or 'event', "
                f"got {self.engine!r}"
            )
        if self.degraded is not None:
            if self.degraded.spec != self.spec:
                raise ValueError(
                    "degraded view describes a different machine than spec"
                )
            if self.degraded.is_trivial:
                object.__setattr__(self, "degraded", None)

    @property
    def value_tag(self) -> str:
        """Which bit-for-bit value family this model prices in. The
        price cache promises byte-stable reads, and the engines agree
        only to tolerance (NumPy vs torch f64 ~1e-15, f32 ~1e-5), so each
        family owns its own cache tables."""
        if self.engine == "batched-torch":
            return "torch-f32" if self.dtype == "float32" else "torch-f64"
        return "event-f64" if self.engine == "event" else "numpy-f64"

    def price_table_key(self, grid: Sequence[int]) -> bytes:
        """The price-cache table digest for one candidate grid: every
        determinant of a step time except the placement. Computable
        without building the schedule — that is what lets a warm cache
        skip the schedule build *and* the pricing."""
        grid = tuple(int(g) for g in grid)
        compute_s = self.step_flops / (self.spec.nprocs
                                       * self.spec.peak_flops)
        parts = [
            repr(_pattern_key(self.pattern)).encode(),
            repr(grid).encode(),
            repr(self.spec).encode(),
            repr((self.elem_bytes, self.steps, self.backpressure,
                  float(compute_s))).encode(),
            self.value_tag.encode(),
        ]
        if self.degraded is not None:
            # Only non-trivial degradations contribute, so every healthy
            # model keeps its pre-existing table digests (and their
            # on-disk caches) unchanged.
            parts.append(repr((self.degraded.dead_procs,
                               self.degraded.contention)).encode())
        return digest(*parts)

    def price_row_key(self, grid: Sequence[int],
                      assign: np.ndarray) -> bytes:
        """The cache row digest of one placement: its isomorphism-class
        representative's bytes (congestion pricing is invariant under
        per-level relabeling, so the whole class shares one row). A
        degraded machine breaks that symmetry — dead procs and non-uniform
        port contention distinguish relabelings — so its rows key on the
        raw placement bytes instead."""
        a = np.asarray(assign, dtype=np.int64)
        if self.degraded is not None:
            return digest(a.tobytes())
        canon = canonical_assignment(a, self.spec.shape)
        return digest(canon.tobytes())

    def _validate(self, factors: Sequence[int]) -> tuple[int, ...]:
        grid = tuple(int(f) for f in factors)
        if self.base is not None:
            self.base.cost(grid)        # validity: propagate ValueError
        if int(np.prod(grid)) != self.spec.nprocs:
            raise ValueError(
                f"grid {grid} does not cover {self.spec.nprocs} processors"
            )
        bound = schedule_transfer_bound(self.pattern, grid)
        if bound > MAX_SCHEDULE_TRANSFERS:
            raise ValueError(
                f"grid {grid} expands to ~{bound:.2g} wire transfers per "
                f"step (> {MAX_SCHEDULE_TRANSFERS}); too large to "
                f"simulate — such a skewed decomposition is never "
                f"time-competitive at this scale"
            )
        return grid

    def _default_assignment(self, grid: tuple[int, ...]) -> np.ndarray:
        if self.assignment_fn is not None:
            return np.asarray(self.assignment_fn(grid))
        return default_assignment(
            self.spec.shape, grid,
            self.pattern.params.get("local_axes", ()),
        )

    def cost(self, factors: Sequence[int]) -> float:
        grid = self._validate(factors)
        assign = self._default_assignment(grid)
        if self.engine == "event":
            return self.simulate(grid, assign).per_step_time()
        if self.cache is not None:
            table = self.price_table_key(grid)
            row = self.price_row_key(grid, assign)
            hit = self.cache.get(table, row)
            if hit is not None:
                return hit
            value = self.batch(grid).step_time(assign)
            self.cache.put(table, row, value)
            return value
        return self.batch(grid).step_time(assign)

    def batch(self, grid: tuple[int, ...]) -> BatchSimulator:
        """The analytic-envelope engine for one candidate grid (memoized
        packed schedule; prices whole assignment stacks in one call).
        Under ``engine="batched-torch"`` this is the device-resident
        :class:`~repro_torch.sim.torch_backend.TorchBatchSimulator` twin."""
        eng = batch_simulator(
            self.pattern, self.spec, grid,
            step_flops=self.step_flops, elem_bytes=self.elem_bytes,
            backpressure=self.backpressure, steps=self.steps,
            degraded=self.degraded,
        )
        if self.engine == "batched-torch":
            from repro_torch.sim.torch_backend import to_torch

            return to_torch(eng, dtype=self.dtype, device=self.device)
        return eng

    def beam_pricer(self, factors: Sequence[int]) -> BatchSimulator | None:
        """The batch engine for pricing a beam of placements of one grid
        (the tuner groups these into one registry-wide pass via
        ``sim.batch.price_stacks``, which lets ``batched-torch`` engines
        price their stacks as their own launches on the card); ``None``
        when this model is pinned to the exact event engine."""
        if self.engine == "event":
            return None
        return self.batch(self._validate(factors))

    def price_assignments(self, factors: Sequence[int],
                          assignments: np.ndarray) -> np.ndarray:
        """(N,) predicted seconds per step for a stack of bijective
        placements of one grid. Batched models price the whole stack in
        one ``candidates x phases x ports`` pass; event models replay
        each placement through the exact queue (the reference both
        engines are benchmarked against)."""
        grid = self._validate(factors)
        if self.engine == "event":
            a = np.asarray(assignments, dtype=np.int64)
            a = a.reshape(a.shape[0], *grid)
            return np.array([
                self.simulate(grid, row).per_step_time() for row in a
            ])
        return self.batch(grid).step_times(assignments)

    def simulate(self, grid: tuple[int, ...], assign: np.ndarray) -> Timeline:
        """The exact event-queue reference for one placement (used for
        ``--simulate`` timelines and engine cross-validation)."""
        topo = Topology.from_spec(self.spec, degraded=self.degraded)
        phases = build_phases(self.pattern, grid, assign,
                              elem_bytes=self.elem_bytes)
        compute_s = self.step_flops / (self.spec.nprocs * self.spec.peak_flops)
        return simulate_steps(
            phases, topo, compute_s=compute_s, steps=self.steps,
            backpressure=self.backpressure,
        )


# --------------------------------------------------------------- application
@dataclasses.dataclass
class SimReport:
    """One simulated application step: the --simulate deliverable."""

    app: str
    procs: int
    machine_shape: tuple[int, ...]
    grid: tuple[int, ...]
    pattern: str
    backpressure: int
    compute_s: float
    comm_s: float                    # network busy time per simulated step
    step_time_s: float               # steady-state seconds per step
    makespan_s: float
    flat_step_time_s: float          # machine.modeled_step_time fast path
    inter_node_bytes_frac: float
    n_phases: int
    max_in_flight: int
    timeline: Timeline
    note: str = ""

    def summary(self) -> dict:
        return {
            "note": self.note,
            "app": self.app,
            "procs": self.procs,
            "machine": list(self.machine_shape),
            "grid": list(self.grid),
            "pattern": self.pattern,
            "backpressure": self.backpressure,
            "compute_s": self.compute_s,
            "comm_s": self.comm_s,
            "step_time_s": self.step_time_s,
            "makespan_s": self.makespan_s,
            "flat_step_time_s": self.flat_step_time_s,
            "inter_node_bytes_frac": self.inter_node_bytes_frac,
            "n_phases": self.n_phases,
            "max_in_flight": self.max_in_flight,
            "timeline": self.timeline.rows(),
        }


def simulate_app(app, procs: int | None = None, *,
                 steps: int = DEFAULT_STEPS,
                 elem_bytes: int = DEFAULT_ELEM_BYTES) -> SimReport:
    """Simulate one registry application's mapped step end to end.

    Runs the real pipeline (``app.spmd_plan`` = parse -> Mapper ->
    translate), reshapes the plan's device permutation into the exact
    tile->processor assignment, expands the app's declared collective
    pattern against it, and executes ``steps`` iterations on the engine
    honoring the plan's ``Backpressure`` depth.
    """
    from repro_torch.core.machine import modeled_step_time

    pattern = getattr(app, "collective", None)
    if pattern is None:
        raise ValueError(
            f"application {app.name!r} declares no collective pattern; "
            f"set Application.collective to simulate it"
        )
    n = app.procs(procs)
    note = ""
    try:
        app.tile_grid(n)
    except ValueError:
        # Same fallback + user-visible note as the tuner's _feasible_procs.
        note = (f"procs {n} infeasible for {app.name}; "
                f"using default {app.default_procs}")
        n = app.default_procs
    plan = app.spmd_plan(n)
    grid = tuple(plan.meta["tile_grid"])
    assign = np.asarray(plan.meta["device_permutation"]).reshape(grid)
    machine_shape = tuple(int(s) for s in app.machine_shape(n))
    spec = spec_for(machine_shape)
    topo = Topology.from_spec(spec)
    phases = build_phases(pattern, grid, assign, elem_bytes=elem_bytes)
    compute_s = app.step_flops(n) / (n * spec.peak_flops)
    timeline = simulate_steps(
        phases, topo, compute_s=compute_s, steps=steps,
        backpressure=plan.backpressure,
    )
    return SimReport(
        app=app.name,
        procs=n,
        machine_shape=machine_shape,
        grid=grid,
        pattern=pattern.kind,
        backpressure=plan.backpressure,
        compute_s=compute_s,
        comm_s=timeline.busy("network") / max(steps, 1),
        step_time_s=timeline.per_step_time(),
        makespan_s=timeline.makespan,
        flat_step_time_s=modeled_step_time(
            app.step_flops(n), app.comm_volume(n), n, elem_bytes=elem_bytes,
        ),
        inter_node_bytes_frac=inter_node_fraction(phases, topo),
        n_phases=len(phases),
        max_in_flight=timeline.max_in_flight,
        timeline=timeline,
        note=note,
    )


def time_search_space(app, *, steps: int = DEFAULT_STEPS,
                      elem_bytes: int = DEFAULT_ELEM_BYTES,
                      engine: str = "batched", dtype: str = "float64",
                      device: str = "cuda",
                      cache: PriceCache | None = None,
                      degraded: DegradedMachine | None = None):
    """The app's SearchSpace with its volume objective swapped for the
    simulator — same grids, options, distributions and orders; only
    ``cost_model`` changes, so the tuner runs unchanged. ``engine``
    picks the batched analytic envelope (default), its device-resident
    torch twin (``"batched-torch"``), or the exact event queue
    (``"event"``, the reference the envelope is validated against);
    ``dtype`` and ``device`` select the torch engine's precision and
    card, and ``cache`` threads a
    persistent :class:`~repro_torch.sim.price_cache.PriceCache` through every
    produced model. ``degraded`` prices every candidate on a degraded
    machine (its spec must match the app's machine shape at the tuned
    processor count — remap tunes fix the shape via a machine_shape
    override)."""
    base_space = app.search_space
    if base_space is None:
        raise ValueError(f"application {app.name!r} declares no search space")
    pattern = getattr(app, "collective", None)
    if pattern is None:
        raise ValueError(f"application {app.name!r} declares no collective")

    def cost_model(procs: int, opts: dict) -> SimulatedTimeCostModel:
        shape = tuple(int(s) for s in app.machine_shape(procs))
        spec = spec_for(shape)
        if degraded is not None and degraded.spec != spec:
            raise ValueError(
                f"degraded machine {degraded.spec.shape} does not match "
                f"{app.name!r}'s machine shape {shape} at {procs} procs; "
                f"fix the shape (e.g. a machine_shape override) before "
                f"tuning degraded"
            )
        return SimulatedTimeCostModel(
            pattern=pattern_with_options(pattern, opts),
            spec=spec,
            step_flops=float(app.step_flops(procs)),
            base=base_space.cost_model(procs, opts),
            elem_bytes=elem_bytes,
            steps=steps,
            engine=engine,
            dtype=dtype,
            device=device,
            cache=cache,
            degraded=degraded,
        )

    return dataclasses.replace(base_space, cost_model=cost_model)


def time_tuned_app(app, *, steps: int = DEFAULT_STEPS,
                   elem_bytes: int = DEFAULT_ELEM_BYTES,
                   engine: str = "batched", dtype: str = "float64",
                   device: str = "cuda",
                   cache: PriceCache | None = None,
                   degraded: DegradedMachine | None = None):
    """A copy of ``app`` whose tuner searches predicted seconds. The
    legacy volume-pair oracle is dropped from the copy (its units are
    elements, not seconds); ``benchmarks/sim_eval.py`` re-checks the
    winner against the volume oracle explicitly."""
    return dataclasses.replace(
        app,
        search_space=time_search_space(app, steps=steps,
                                       elem_bytes=elem_bytes, engine=engine,
                                       dtype=dtype, device=device,
                                       cache=cache,
                                       degraded=degraded),
        tuning=None,
    )


__all__ = [
    "DEFAULT_ELEM_BYTES",
    "DEFAULT_STEPS",
    "MAX_SCHEDULE_TRANSFERS",
    "SimReport",
    "SimulatedTimeCostModel",
    "default_assignment",
    "inter_node_fraction",
    "pattern_with_options",
    "simulate_app",
    "spec_for",
    "time_search_space",
    "time_tuned_app",
]
