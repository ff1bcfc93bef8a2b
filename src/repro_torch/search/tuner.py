"""The mapper autotuner: cost-model-driven search over mapper IR programs.

Replaces the hand-coded ``(default, tuned)`` volume pairs of the Table 2
experiment with an actual search loop:

  1. enumerate every candidate grid x option combination of the app's
     :class:`~repro_torch.search.space.SearchSpace` and score it analytically
     with the app's :class:`~repro_torch.core.commvolume.CostModel`;
  2. prune to a beam of the lowest-volume survivors (volume dominates —
     distribution/order variants of a dominated grid can never win);
  3. expand the beam into distribution x order variants, materialize each
     as a mapping-IR program, and evaluate it through the vectorized
     ``Mapper.assignment_grid`` batch path (bijectivity + cross-node
     locality of nearest-neighbour hops), deduping placements that are
     isomorphic under per-level processor relabeling
     (``sim.batch.canonical_assignment`` — identical port loads can
     never rank differently); when the cost model is time-domain (it
     exposes ``price_assignments``), the surviving beam's *actual*
     placements are priced in one batched simulator call — the batch
     engine folds translation-symmetric schedule slabs to one
     representative per candidate and re-prices only the slabs a beam
     neighbor actually moved relative to its group's base candidate
     (``sim.batch.FOLD_STATS`` counts both), so the sweep stays cheap
     at 100k+ processors;
  4. rank by (placed seconds when simulated, else volume; then
     cross-node fraction) and render the winner back to Mapple DSL
     source, verifying the parsed source reproduces the winning
     permutation bit-for-bit.

The app's legacy ``tuning`` pair is treated as a *regression oracle*: the
tuner must rediscover (or beat) the hand-tuned volume; tests and the
Table 2 benchmark assert it, nothing trusts it as ground truth.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np

from repro_torch.core import dsl
from repro_torch.core.machine import GPU, Machine
from repro_torch.sim.batch import canonical_assignment
from repro_torch.sim.price_cache import digest
from repro_torch.search.pipeline import PriceJob, price_jobs, stream_priced
from repro_torch.search.space import (
    BLOCK_CYCLIC,
    Candidate,
    CandidateProgram,
    SearchSpace,
    build_program,
    render_source,
)

DEFAULT_BEAM = 6          # lowest-volume (grid, options) pairs kept for eval
DEFAULT_LEADERBOARD = 12  # ranked candidates surfaced in the report


@dataclasses.dataclass
class ScoredCandidate:
    """One candidate with its analytic volume and (if evaluated through the
    batch path) its locality/bijectivity measurements."""

    candidate: Candidate
    volume: float
    evaluated: bool = False
    bijective: bool | None = None
    cross_node: float | None = None
    eval_path: str | None = None       # "vectorized" | "per-point"
    # Time-domain tuning only: the batched simulator's predicted seconds
    # for this variant's ACTUAL placement (Phase 1's `volume` slot holds
    # the grid's default-placement score).
    placed_cost: float | None = None

    @property
    def rank_cost(self) -> float:
        """What this candidate is ranked by: placed simulated seconds
        when the beam was batch-priced, the analytic score otherwise."""
        return self.volume if self.placed_cost is None else self.placed_cost

    def row(self) -> dict:
        return {
            "candidate": self.candidate.describe(),
            "grid": list(self.candidate.grid),
            "volume": self.volume,
            "evaluated": self.evaluated,
            "bijective": self.bijective,
            "cross_node": self.cross_node,
            "eval_path": self.eval_path,
            "placed_cost": self.placed_cost,
        }


@dataclasses.dataclass
class TuningReport:
    """The tuner's full result for one application at one scale."""

    app: str
    procs: int
    machine_shape: tuple[int, ...]
    candidates_considered: int       # grid x option points scored analytically
    variants_evaluated: int          # IR programs run through the batch path
    pruned: int                      # candidates dropped by the beam
    best: ScoredCandidate
    best_program: CandidateProgram
    best_source: str
    best_ir: str
    verified: bool                   # rendered DSL reproduces the permutation
    default: ScoredCandidate | None  # the untuned baseline, scored
    oracle: tuple[float, float] | None   # legacy (default, tuned) pair
    leaderboard: list[ScoredCandidate]
    elapsed_s: float
    note: str = ""
    #: Wall-clock of Phase 3 alone (variant expansion + placement
    #: pricing, producer/consumer or barrier) — the region ``pipeline``
    #: reshapes, and the one the pipeline benchmark compares.
    phase3_s: float = 0.0
    #: Warm-start seeds that actually joined the beam (0 for a cold
    #: search, or when every seed was already shortlisted — in which
    #: case the report is bit-identical to the cold one).
    warm_seeds: int = 0

    @property
    def oracle_ok(self) -> bool:
        """Regression check: search rediscovered (or beat) the hand-tuned
        volume, and reproduced the hand-coded default baseline exactly."""
        if self.oracle is None:
            return True
        v_def, v_tuned = self.oracle
        default_ok = self.default is None or self.default.volume == v_def
        return default_ok and self.best.volume <= v_tuned * (1 + 1e-9)

    def summary(self) -> dict:
        return {
            "app": self.app,
            "procs": self.procs,
            "machine": list(self.machine_shape),
            "candidates": self.candidates_considered,
            "evaluated": self.variants_evaluated,
            "pruned": self.pruned,
            "best": self.best.row(),
            "default": None if self.default is None else self.default.row(),
            "oracle": None if self.oracle is None else list(self.oracle),
            "oracle_ok": self.oracle_ok,
            "verified": self.verified,
            "best_ir": self.best_ir,
            "elapsed_s": self.elapsed_s,
            "phase3_s": self.phase3_s,
            "warm_seeds": self.warm_seeds,
            "note": self.note,
        }


def cross_node_fraction(node_grid: np.ndarray) -> float:
    """Fraction of nearest-neighbour hops (one hop per axis per tile, with
    wraparound — the shift/halo neighbour structure) crossing nodes."""
    total = cross = 0
    for axis in range(node_grid.ndim):
        if node_grid.shape[axis] == 1:
            continue
        rolled = np.roll(node_grid, -1, axis=axis)
        cross += int((rolled != node_grid).sum())
        total += node_grid.size
    return cross / total if total else 0.0


def _feasible_procs(space: SearchSpace, app, procs: int | None) -> tuple[int, str]:
    n = app.procs(procs)
    if space.grids(n):
        return n, ""
    note = f"procs {n} infeasible for {app.name}; using default {app.default_procs}"
    return app.default_procs, note


def feasible_procs(space: SearchSpace, n: int) -> bool:
    """True when at least one (grid, options) point of ``space`` prices at
    ``n`` processors — the exact Phase-1 feasibility test, so callers can
    validate a ``--procs`` request up front instead of failing deep
    inside the search."""
    grids = space.grids(n)
    if not grids:
        return False
    for options in space.option_combos():
        model = space.cost_model(n, dict(options))
        for grid in grids:
            try:
                float(model.cost(grid))
            except ValueError:
                continue
            return True
    return False


def nearest_feasible_procs(space: SearchSpace, n: int, *, count: int = 4,
                           max_delta: int = 4096) -> list[int]:
    """The ``count`` feasible processor counts nearest to ``n`` (within
    ``n ± max_delta``, nearest first) — the actionable half of the CLI's
    invalid ``--procs`` error."""
    found: list[int] = []
    for delta in range(1, max_delta + 1):
        for m in (n - delta, n + delta):
            if m >= 1 and feasible_procs(space, m):
                found.append(m)
        if len(found) >= count:
            break
    return found[:count]


def _admit_seed(space: SearchSpace, seed, n: int, grid_set: set,
                combos: set) -> tuple | None:
    """Validate one warm-start seed against the live search space.

    Returns the Phase-1 ``(volume, grid, options)`` entry the seed
    contributes, or ``None`` when the seed is stale or incompatible
    (wrong grid rank, infeasible grid, unknown option point, cost model
    rejection) — skipped, never fatal."""
    try:
        grid = tuple(int(g) for g in seed.grid)
        options = tuple((str(k), str(v)) for k, v in seed.options)
    except (AttributeError, TypeError, ValueError):
        return None
    if len(grid) != space.rank or grid not in grid_set:
        return None
    if options not in combos:
        return None
    try:
        volume = float(space.cost_model(n, dict(options)).cost(grid))
    except (ValueError, ArithmeticError):
        return None
    return (volume, grid, options)


def refit_candidate(space: SearchSpace, cand: Candidate,
                    procs: int) -> Candidate | None:
    """Re-instantiate a candidate from a *different* scale on the
    feasible grid of ``procs`` nearest in shape to its own (log-ratio
    distance per axis, ties lexicographic) — how the tuning service
    turns a cached winner from a nearby processor count into a
    ``warm_start`` seed. Distribution/order carry over when the rank
    matches; returns ``None`` when nothing feasible fits."""
    grids = space.grids(procs)
    if not grids:
        return None
    try:
        seed_grid = tuple(int(g) for g in cand.grid)
    except (TypeError, ValueError):
        return None
    if len(seed_grid) != space.rank or any(g < 1 for g in seed_grid):
        return None
    if seed_grid in grids:
        grid = seed_grid
    else:
        import math

        def dist(g: tuple[int, ...]) -> float:
            return sum((math.log(a) - math.log(b)) ** 2
                       for a, b in zip(g, seed_grid))

        grid = min(grids, key=lambda g: (dist(g), g))
    k = len(grid)
    d = tuple(cand.dist) if len(cand.dist) == k else (BLOCK_CYCLIC,) * k
    order = (tuple(cand.order) if sorted(cand.order) == list(range(k))
             else tuple(range(k)))
    return Candidate(grid=grid, dist=d, order=order, options=cand.options)


@dataclasses.dataclass
class PendingTune:
    """A tune split at the Phase-3 pricing boundary.

    ``prepare_tune`` runs Phases 1–2 (analytic scoring, beam pruning,
    warm-seed admission) and returns this handle; :meth:`jobs` is the
    Phase-3 expansion generator (consume exactly once — each yielded
    :class:`PriceJob` needs its ``placed_cost`` written, via
    ``price_jobs``/``stream_priced``); :meth:`finish` runs Phase 4 and
    builds the :class:`TuningReport`. ``tune_app`` composes the three
    inline; a tuning service holds several PendingTunes open at once so
    their jobs price in shared cross-request ``price_stacks`` passes.
    """

    app: "object"
    space: SearchSpace
    n: int
    machine_shape: tuple[int, ...]
    scored: list
    shortlist: list
    pruned: int
    note: str
    leaderboard_n: int
    warm_seeds: int
    t0: float
    evaluated: list = dataclasses.field(default_factory=list)
    seen: dict = dataclasses.field(default_factory=dict)
    phase3_s: float = 0.0

    @property
    def prices_async(self) -> bool:
        """True when the cost model prices on the asynchronous-dispatch
        torch engine — the case where streaming Phase 3 pays."""
        probe = self.space.cost_model(self.n, dict(self.shortlist[0][2]))
        return getattr(probe, "engine", None) == "batched-torch"

    def jobs(self):
        """Walk the shortlist, expand + dedupe variants, and yield one
        :class:`PriceJob` per beam entry whose placements a batch engine
        will price. Runs on the pipeline's producer thread (all mutation
        of ``seen``/``evaluated`` stays on this generator's thread; the
        consumer only writes ``placed_cost``). Models without a batch
        pricer fall back inline: the exact event engine prices here,
        volume models emit nothing and rank by locality alone."""
        space, n, machine_shape = self.space, self.n, self.machine_shape
        seen, evaluated, app = self.seen, self.evaluated, self.app
        for volume, grid, options in self.shortlist:
            survivors: list[tuple[ScoredCandidate, np.ndarray, bytes]] = []
            model = space.cost_model(n, dict(options))
            # A degraded machine (dead procs, non-uniform port contention)
            # breaks the per-level relabeling symmetry, so its dedup keys
            # and price-cache rows use the raw placement bytes instead of
            # the isomorphism-class representative.
            degraded = getattr(model, "degraded", None)
            for cand in space.variants(grid, options, machine_shape):
                program = build_program(machine_shape, cand,
                                        f"{app.name}_cand")
                assign = program.mapper.assignment_grid(cand.grid,
                                                        use_cache=False)
                # Dedupe same-(grid, options) variants whose placements
                # are isomorphic under per-level processor relabeling —
                # identical port loads, so identical volume, time and
                # locality; distinct option points stay on the
                # leaderboard even when their permutations coincide
                # (their volumes differ).
                if degraded is not None:
                    canon = np.asarray(assign, dtype=np.int64).tobytes()
                else:
                    canon = canonical_assignment(assign,
                                                 machine_shape).tobytes()
                key = (cand.grid, cand.options, canon)
                twin = seen.get(key)
                if twin is not None:  # isomorphic variant already seen
                    # Isomorphs tie on every ranking key, so keep the
                    # describe()-minimal one as the class representative
                    # — the winner the pre-dedup sort would have picked,
                    # independent of enumeration order.
                    if cand.describe() < twin.candidate.describe():
                        twin.candidate = cand
                    continue
                flat = assign.reshape(-1)
                bijective = flat.size == n and len(np.unique(flat)) == n
                node_grid = assign // machine_shape[1]
                entry = ScoredCandidate(
                    candidate=cand,
                    volume=volume,
                    evaluated=True,
                    bijective=bijective,
                    cross_node=cross_node_fraction(node_grid),
                    eval_path=program.mapper.last_eval_path,
                )
                seen[key] = entry
                evaluated.append(entry)
                if bijective:
                    survivors.append((entry, np.asarray(assign), canon))
            # Time-domain models price the surviving beam's ACTUAL
            # placements through the batch engine; volume models keep
            # ranking variants by locality alone.
            if not survivors:
                continue
            engine = getattr(model, "beam_pricer", lambda g: None)(grid)
            stack = np.stack([a for _, a, _ in survivors])
            entries = [e for e, _, _ in survivors]
            if engine is not None:
                cache = getattr(model, "cache", None)
                table = rows = None
                if cache is not None:
                    # Row digests reuse the dedup pass's canonical
                    # bytes — the cache key costs nothing extra here.
                    table = model.price_table_key(grid)
                    rows = [digest(c) for _, _, c in survivors]
                yield PriceJob(engine=engine, stack=stack, entries=entries,
                               table=table, rows=rows, cache=cache)
            elif hasattr(model, "price_assignments"):
                # Per-group fallback (e.g. the exact event engine).
                for entry, t in zip(entries,
                                    model.price_assignments(grid, stack)):
                    entry.placed_cost = float(t)

    def finish(self) -> TuningReport:
        """Phase 4: rank the evaluated variants, render the winner back
        to Mapple DSL source, verify the parse round-trip, score the
        untuned default and the legacy oracle, and assemble the report.
        Call only after every job from :meth:`jobs` has had its
        ``placed_cost`` written."""
        app, space = self.app, self.space
        n, machine_shape = self.n, self.machine_shape
        ranked = sorted(
            (s for s in self.evaluated if s.bijective),
            key=lambda s: (s.rank_cost, s.cross_node,
                           s.candidate.describe()),
        )
        if not ranked:
            raise ValueError(
                f"no bijective candidate survived for {app.name} at {n} procs"
            )
        best = ranked[0]

        best_program = build_program(machine_shape, best.candidate,
                                     f"{app.name}_tuned")
        directives = None
        if space.directives is not None:
            directives = space.directives(app.name, best.candidate.opts)
        source = render_source(app.name, best_program, directives)
        parsed = dsl.parse(
            source,
            machine_factory=lambda *a, **k: Machine(GPU, shape=machine_shape),
        )
        parsed_mapper = parsed.mappers[parsed.index_task_maps[app.name]]
        verified = bool(np.array_equal(
            parsed_mapper.assignment_grid(best.candidate.grid,
                                          use_cache=False),
            best_program.mapper.assignment_grid(best.candidate.grid),
        ))

        default_scored: ScoredCandidate | None = None
        default_cand = space.default_candidate(n)
        if default_cand is not None:
            model = space.cost_model(n, default_cand.opts)
            try:
                default_scored = ScoredCandidate(
                    candidate=default_cand,
                    volume=float(model.cost(default_cand.grid)),
                )
            except ValueError:
                default_scored = None

        oracle: tuple[float, float] | None = None
        if app.tuning is not None:
            try:
                oracle = tuple(app.tuning(n))  # type: ignore[assignment]
            except ValueError:
                oracle = None

        return TuningReport(
            app=app.name,
            procs=n,
            machine_shape=machine_shape,
            candidates_considered=len(self.scored),
            variants_evaluated=len(self.evaluated),
            pruned=self.pruned,
            best=best,
            best_program=best_program,
            best_source=source,
            best_ir=best_program.space.describe(),
            verified=verified,
            default=default_scored,
            oracle=oracle,
            leaderboard=ranked[:self.leaderboard_n],
            elapsed_s=time.perf_counter() - self.t0,
            phase3_s=self.phase3_s,
            note=self.note,
            warm_seeds=self.warm_seeds,
        )


def prepare_tune(app, procs: int | None = None, *, beam: int = DEFAULT_BEAM,
                 leaderboard: int = DEFAULT_LEADERBOARD,
                 warm_start: Iterable[Candidate] = (),
                 restrict: Iterable[Candidate] | None = None) -> PendingTune:
    """Phases 1–2 of :func:`tune_app`, returned as a :class:`PendingTune`.

    ``warm_start`` seeds (cached winners from a nearby scale, refit via
    :func:`refit_candidate`) join the beam *in addition to* the
    lowest-volume shortlist — a superset of the cold search space, so a
    warm search can never rank worse than the cold one, and when every
    seed is already shortlisted the report is bit-identical to cold
    (``warm_seeds == 0``). Stale or incompatible seeds are skipped.

    ``restrict`` turns Phase 1 into a *seeded* scan: only the given
    candidates' (grid, options) points (plus the space's default
    candidate as a safety net) are scored, instead of the full
    combos × grids enumeration. This is the fast path for failure
    remaps, where a known-good plan exists and scoring thousands of
    analytic points — each a device pricing for time-domain spaces —
    would dominate recovery latency. Falls back to the full enumeration
    when every restricted point is stale or infeasible.
    """
    space: SearchSpace | None = app.search_space
    if space is None:
        raise ValueError(f"application {app.name!r} declares no search space")
    t0 = time.perf_counter()
    n, note = _feasible_procs(space, app, procs)
    machine_shape = tuple(int(s) for s in app.machine_shape(n))

    # Phase 1: analytic scoring of every (grid, options) point — or, under
    # ``restrict``, of just the seeded points.
    grids = space.grids(n)
    scored: list[tuple[float, tuple[int, ...], tuple[tuple[str, str], ...]]] = []
    if restrict is not None:
        combo_set = set(space.option_combos())
        grid_set = set(grids)
        wanted = list(restrict)
        default_cand = space.default_candidate(n)
        if default_cand is not None:
            wanted.append(default_cand)
        seen_points: set[tuple] = set()
        for cand in wanted:
            entry = _admit_seed(space, cand, n, grid_set, combo_set)
            if entry is None or (entry[1], entry[2]) in seen_points:
                continue
            seen_points.add((entry[1], entry[2]))
            scored.append(entry)
        if scored:
            extra = (f"restricted search: {len(scored)} seeded point(s) "
                     f"scored in place of the full enumeration")
            note = f"{note}; {extra}" if note else extra
    if not scored:
        for options in space.option_combos():
            model = space.cost_model(n, dict(options))
            for grid in grids:
                try:
                    volume = float(model.cost(grid))
                except ValueError:
                    continue
                scored.append((volume, grid, options))
    if not scored:
        near = nearest_feasible_procs(space, n, max_delta=256)
        hint = f"; nearest feasible proc counts: {near}" if near else ""
        raise ValueError(
            f"no feasible candidate for {app.name} at {n} procs{hint}")
    scored.sort()

    # Phase 2: beam prune — a grid whose volume is dominated can never win,
    # since distribution/order variants only change locality, not volume.
    shortlist = list(scored[:max(beam, 1)])
    pruned = len(scored) - len(shortlist)

    # Warm-start admission: each seed that survives validation appends
    # its (grid, options) group to the shortlist unless Phase 2 kept it
    # already — strictly widening the beam, never replacing it.
    warm_admitted = 0
    seeds = list(warm_start)
    if seeds:
        combos = set(space.option_combos())
        grid_set = set(grids)
        have = {(g, o) for _, g, o in shortlist}
        for seed in seeds:
            entry = _admit_seed(space, seed, n, grid_set, combos)
            if entry is None or (entry[1], entry[2]) in have:
                continue
            have.add((entry[1], entry[2]))
            shortlist.append(entry)
            warm_admitted += 1
        if warm_admitted:
            extra = f"warm-start: {warm_admitted}/{len(seeds)} seeds joined the beam"
            note = f"{note}; {extra}" if note else extra

    return PendingTune(
        app=app,
        space=space,
        n=n,
        machine_shape=machine_shape,
        scored=scored,
        shortlist=shortlist,
        pruned=pruned,
        note=note,
        leaderboard_n=leaderboard,
        warm_seeds=warm_admitted,
        t0=t0,
    )


def tune_app(app, procs: int | None = None, *, beam: int = DEFAULT_BEAM,
             leaderboard: int = DEFAULT_LEADERBOARD,
             pipeline: bool | None = None,
             warm_start: Iterable[Candidate] = (),
             restrict: Iterable[Candidate] | None = None) -> TuningReport:
    """Search one application's mapper space; returns the full report.

    ``pipeline`` controls Phase 3's execution shape: ``True`` streams
    expansion and pricing through ``repro_torch.search.pipeline`` (host
    expands group k+1 while the device prices group k), ``False`` keeps
    the strict barrier (expand everything, then one packed pricing
    sweep), ``None`` (default) picks the pipeline exactly when the cost
    model prices on the asynchronous-dispatch torch engine — the host
    NumPy engine gains more from the barrier path's cross-group packing
    than from overlap. Both shapes produce bit-identical reports.

    ``warm_start`` seeds (e.g. cached winners from a nearby scale) widen
    the beam per :func:`prepare_tune` — results are never worse than the
    cold search, and bit-identical to it when no seed is novel.
    """
    pending = prepare_tune(app, procs, beam=beam, leaderboard=leaderboard,
                           warm_start=warm_start, restrict=restrict)

    # Phase 3: variant expansion + batch pricing — as a producer/consumer
    # pipeline (expansion of group k+1 overlaps device pricing of group
    # k) or as the legacy barrier, per ``pipeline``; identical numbers
    # either way.
    if pipeline is None:
        pipeline = pending.prices_async
    t3 = time.perf_counter()
    if pipeline:
        for job, times in stream_priced(pending.jobs()):
            for entry, t in zip(job.entries, times):
                entry.placed_cost = float(t)
    else:
        # All shortlisted grids x options in one candidates x phases
        # x ports pricing sweep, cache hits excluded up front.
        price_jobs(list(pending.jobs()))
    pending.phase3_s = time.perf_counter() - t3
    return pending.finish()


def tune_registry(applications: Iterable, procs: int | None = None,
                  *, beam: int = DEFAULT_BEAM,
                  pipeline: bool | None = None) -> list[TuningReport]:
    """Tune every application that declares a search space."""
    return [
        tune_app(app, procs, beam=beam, pipeline=pipeline)
        for app in applications
        if getattr(app, "search_space", None) is not None
    ]


def report_lines(report: TuningReport) -> list[str]:
    """Human-readable leaderboard + winner block for the --tune CLI."""
    lines = [
        f"[{report.app}] procs={report.procs} "
        f"machine={report.machine_shape[0]}x{report.machine_shape[1]} "
        f"candidates={report.candidates_considered} "
        f"evaluated={report.variants_evaluated} pruned={report.pruned} "
        f"({report.elapsed_s * 1e3:.1f} ms)"
        + (f"  {report.note}" if report.note else "")
    ]
    timed = any(s.placed_cost is not None for s in report.leaderboard)
    placed_hdr = f" {'placed_s':>10s}" if timed else ""
    lines.append(
        f"  {'candidate':32s} {'volume':>12s}{placed_hdr} "
        f"{'xnode':>6s} {'bij':>4s}"
    )
    for s in report.leaderboard:
        xnode = f"{s.cross_node:6.2f}" if s.cross_node is not None else "     -"
        placed = ""
        if timed:
            placed = (f" {s.placed_cost:10.3e}" if s.placed_cost is not None
                      else f" {'-':>10s}")
        lines.append(
            f"  {s.candidate.describe():32s} {s.volume:12.4g}{placed} {xnode} "
            f"{str(bool(s.bijective)):>4s}"
        )
    if report.default is not None:
        ratio = report.default.volume / max(report.best.volume, 1e-12)
        lines.append(
            f"  default {report.default.candidate.describe()} "
            f"volume={report.default.volume:.4g} "
            f"-> best ratio {ratio:.2f}x"
        )
    if report.oracle is not None:
        lines.append(
            f"  oracle (default, tuned)=({report.oracle[0]:.4g}, "
            f"{report.oracle[1]:.4g}) rediscovered={report.oracle_ok}"
        )
    lines.append(f"  best mapper IR: {report.best_ir}")
    lines.append(f"  dsl-verified: {report.verified}")
    lines.append("  best Mapple program:")
    lines.extend(f"    {ln}" for ln in report.best_source.rstrip().splitlines())
    return lines


__all__ = [
    "DEFAULT_BEAM",
    "PendingTune",
    "ScoredCandidate",
    "TuningReport",
    "cross_node_fraction",
    "feasible_procs",
    "nearest_feasible_procs",
    "prepare_tune",
    "refit_candidate",
    "report_lines",
    "tune_app",
    "tune_registry",
]
