"""Batched analytic-envelope engine: price whole candidate beams at once.

The event engine (``repro_torch.sim.engine``) replays one placement's step
loop task by task — exact, but a Python heap walk per candidate. For
*search* the repeated structure is enormous: every candidate of a tuner
beam shares the same tile-space schedule (``PackedSchedule``), the same
compute leg, and the same steady-state step recurrence; only the
tile->processor assignment (and hence the congestion prices) changes.

:class:`BatchSimulator` exploits that. It prices a stack of candidate
assignments in one vectorized ``candidates x phases x ports`` pass
(``Topology.bucket_times``) and collapses the step recurrence to its
closed form. For a constant per-step schedule the event queue's
steady-state marginal step time is exactly

  * ``compute + comm``        when ``backpressure == 1`` (or a single
    step): compute, its phases, then the gate — fully serial;
  * ``max(compute, comm)``    when ``backpressure >= 2``: the serial
    network stream pipelines one step behind the compute stream, so the
    slower resource sets the cadence

with ``comm`` the chained sum of that step's phase durations. Both legs
reproduce ``Timeline.per_step_time()`` to float rounding —
``benchmarks/sim_eval.py`` and ``tests/test_sim.py`` hold the two
engines to 1e-9 agreement across the registry — while the event engine
stays the exact reference for ``--simulate`` timelines, warmup
transients, and ``Backpressure`` in-flight depth accounting.

:func:`canonical_assignment` is the symmetry companion: congestion
pricing is invariant under relabeling subtrees within a machine level
(every port of a level shares one bandwidth), so placements that agree
up to node / within-node processor renaming are *isomorphic* — the
tuner dedups them before pricing.

The same invariance powers the scaled pricing paths. When a schedule
slab is a tile-grid *translation* of another (``PackedSchedule.fold_rep``
— e.g. SUMMA's round-``r`` panel broadcast is round 0 shifted ``r``
columns) and the candidate assignment is itself periodic under that
shift (checked per candidate: the induced processor permutation must
keep every machine level's subtrees intact), the translated slab's
congestion price *is* the representative's, bit for bit — so hundreds of
broadcast rounds price as a handful of representatives. Likewise a beam
neighbor that moved only a few tiles re-prices only the slabs touching
them, copying the rest from the stack's base candidate
(``incremental``). Both shortcuts are exact, never approximations:
``FOLD_STATS`` counts what was folded, reused, priced, or fell back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.machine import DegradedMachine, MachineSpec
from repro_torch.sim.collectives import (
    CollectivePattern,
    PackedSchedule,
    packed_schedule,
)
from repro_torch.sim.topology import Topology

#: Cap on ``candidates_per_chunk * transfers`` for one gather/pricing
#: pass, bounding peak memory of the (chunk, T) endpoint arrays.
_MAX_GATHER_ELEMS = 1 << 24

#: Counter keys for the scaled pricing paths. A "pair" is one
#: (candidate, unique-slab) congestion price.
FOLD_STAT_KEYS = (
    "pairs_priced",     # priced directly via Topology.bucket_times
    "pairs_folded",     # copied from a translation representative
    "pairs_reused",     # copied from the stack's base candidate
    "fold_fallbacks",   # candidates whose assignment broke a fold
)

#: Process-lifetime instrumentation totals. Kept as a module global for
#: backward compatibility (reset with :func:`fold_stats_reset`), but
#: concurrent or nested runs should scope their counts with the
#: :func:`fold_stats` context manager instead of resetting this dict —
#: a reset in one run silently corrupts another run's readings.
FOLD_STATS = {key: 0 for key in FOLD_STAT_KEYS}

#: Guards the global totals: the streaming tuner pipeline prices on a
#: consumer thread while the producer expands candidates, so the legacy
#: dict would race its read-modify-write increments without it. The
#: thread-local scope stacks need no lock (each thread sees only its
#: own), and per-key increments merge atomically under the lock.
_FOLD_LOCK = threading.Lock()

_FOLD_SCOPES = threading.local()


def _fold_scopes() -> list[dict]:
    scopes = getattr(_FOLD_SCOPES, "stack", None)
    if scopes is None:
        scopes = _FOLD_SCOPES.stack = []
    return scopes


def _count(key: str, n: int) -> None:
    """Bump one fold counter: the global totals (lock-protected — the
    pipeline's producer and consumer threads price concurrently) plus
    every counter opened by this thread's active :func:`fold_stats`
    scopes (so nested scopes each see the events of the work they
    wrap)."""
    with _FOLD_LOCK:
        FOLD_STATS[key] += n
    for counter in _fold_scopes():
        counter[key] += n


@contextlib.contextmanager
def fold_stats() -> Iterator[dict]:
    """Scope a pricing run's fold instrumentation.

    Yields a fresh per-run counter dict (the :data:`FOLD_STAT_KEYS`)
    that accumulates only the events of pricing performed inside the
    ``with`` block on the current thread. Unlike resetting the module
    global, scopes are safe to nest and cannot corrupt a concurrent
    run's counts; the global :data:`FOLD_STATS` totals keep
    accumulating regardless.
    """
    counter = {key: 0 for key in FOLD_STAT_KEYS}
    scopes = _fold_scopes()
    scopes.append(counter)
    try:
        yield counter
    finally:
        scopes.remove(counter)


def fold_stats_snapshot() -> dict:
    """A point-in-time copy of the global fold counters."""
    return dict(FOLD_STATS)


def fold_stats_reset() -> None:
    """Zero the global :data:`FOLD_STATS` totals (legacy API; prefer the
    :func:`fold_stats` scope, which needs no reset)."""
    with _FOLD_LOCK:
        for key in FOLD_STATS:
            FOLD_STATS[key] = 0


class ReadyPrices:
    """An already-materialized pricing result behind the async handle
    protocol (``result()``): the host NumPy engine computes eagerly on
    the calling thread, so its "handle" is just the finished array. The
    torch engine overrides :meth:`BatchSimulator.step_times_async` with a
    genuinely deferred handle (the launches return before the card
    finishes)."""

    __slots__ = ("_value",)

    def __init__(self, value: np.ndarray) -> None:
        self._value = value

    def result(self) -> np.ndarray:
        return self._value


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _is_permutation(flat: np.ndarray, nprocs: int) -> bool:
    if flat.size != nprocs or flat.size == 0:
        return False
    if int(flat.min()) < 0 or int(flat.max()) >= nprocs:
        return False
    seen = np.zeros(nprocs, dtype=bool)
    seen[flat] = True
    return bool(seen.all())


def _chunk_pairs(sizes: np.ndarray, cap: int) -> list[tuple[int, int]]:
    """Split a pair list into contiguous chunks whose transfer totals stay
    under ``cap`` (a single oversize pair still gets its own chunk)."""
    if sizes.size == 0:
        return []
    csum = np.cumsum(sizes)
    bounds = []
    lo, base = 0, 0
    while lo < sizes.size:
        hi = int(np.searchsorted(csum, base + cap, side="right"))
        hi = max(hi, lo + 1)
        bounds.append((lo, hi))
        base = int(csum[hi - 1])
        lo = hi
    return bounds


@dataclasses.dataclass(frozen=True)
class BatchSimulator:
    """Analytic-envelope pricing of many placements of one schedule.

    ``assignments`` arguments accept shape ``(N, *grid)`` or
    ``(N, prod(grid))`` stacks of **bijective** tile->processor
    placements (the tuner filters bijectivity before pricing; local
    transfers were already dropped in tile space).
    """

    topology: Topology
    schedule: PackedSchedule
    compute_s: float
    backpressure: int = 2
    steps: int = 3

    def __post_init__(self) -> None:
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.backpressure < 1:
            raise ValueError(
                f"backpressure must be >= 1, got {self.backpressure}"
            )

    # ---------------------------------------------------------------- pricing
    def _flat_assignments(self, assignments: np.ndarray) -> np.ndarray:
        a = np.asarray(assignments, dtype=np.int64)
        ntiles = int(np.prod(self.schedule.grid))
        if a.ndim == len(self.schedule.grid) + 1 \
                and a.shape[1:] == self.schedule.grid:
            a = a.reshape(a.shape[0], ntiles)
        if a.ndim != 2 or a.shape[1] != ntiles:
            raise ValueError(
                f"assignments shape {np.asarray(assignments).shape} does not "
                f"stack placements of tile grid {self.schedule.grid}"
            )
        return a

    # -------------------------------------------------- symmetry folding
    def _shift_symmetric(self, agrid: np.ndarray, axis: int,
                         step: int) -> bool:
        """True when translating the tile grid ``step`` tiles along
        ``axis`` (wraparound) maps this assignment onto a machine
        symmetry: the induced processor permutation keeps every level's
        subtrees intact, so every port's transfer list — and therefore
        every congestion price — is unchanged bit for bit."""
        a = agrid.reshape(-1)
        b = np.roll(agrid, -step, axis=axis).reshape(-1)
        inv = np.empty(a.size, dtype=np.int64)
        inv[a] = np.arange(a.size, dtype=np.int64)
        perm = b[inv]                    # processor permutation: b = perm∘a
        degraded = self.topology.degraded
        for lvl, stride in enumerate(self.topology.port_strides):
            if stride == 1:
                # Every proc is its own port: any permutation permutes the
                # ports, and uniform bandwidth makes that free — unless
                # per-port contention breaks the port symmetry.
                if degraded is not None and degraded.contention is not None:
                    cont = np.asarray(degraded.port_contention(lvl))
                    if not (cont[perm] == cont).all():
                        return False
                continue
            blocks = (perm // stride).reshape(-1, stride)
            if not (blocks == blocks[:, :1]).all():
                return False
            if degraded is not None and degraded.contention is not None:
                # The shift permutes this level's ports (port q -> image
                # of its block); the fold is only exact if the induced
                # port map preserves each port's contention factor.
                cont = np.asarray(degraded.port_contention(lvl))
                img = blocks[:, 0]
                if not (cont[img] == cont).all():
                    return False
        return True

    def _axis_period(self, agrid: np.ndarray, axis: int) -> int:
        """Smallest tile translation along ``axis`` that is a machine
        symmetry of this assignment (compatible shifts compose, so every
        multiple of the period folds too; the axis extent itself — only
        the zero shift — when the assignment has no periodicity)."""
        extent = agrid.shape[axis]
        for q in _divisors(extent):
            if q == extent or self._shift_symmetric(agrid, axis, q):
                return q
        return extent

    def _plan(self, a: np.ndarray, fold: bool, incremental: bool
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-(candidate, slab) pricing plan for a stack.

        Returns ``(rep, unch, need)``, all shaped ``(N, n_unique)``:
        ``rep[c, s]`` is the slab whose priced time slab ``s`` of
        candidate ``c`` copies — its translation-class representative
        under the candidate's own periodicities, ``s`` itself when it
        must be priced; ``unch[c, s]`` marks slabs whose physical
        transfers are identical to candidate 0's, so the base row's time
        is reused (exact: same endpoint arrays, independent buckets);
        ``need`` is the mask of pairs that go to ``bucket_times``. Both
        shortcuts reproduce the dense result bit for bit, enforced by
        tests/test_scale.py and the ``sim_eval --scale`` fold-parity
        lane.
        """
        sched = self.schedule
        n, u = a.shape[0], sched.n_unique
        slab_ids = np.arange(u, dtype=np.int64)
        rep = np.tile(slab_ids, (n, 1))
        unch = np.zeros((n, u), dtype=bool)
        frep, fshift = sched.fold_rep, sched.fold_shift
        nprocs = self.topology.nprocs
        foldable = (fold and (frep != slab_ids).any()
                    and int(np.prod(sched.grid)) == nprocs)
        if foldable:
            axes = np.flatnonzero((fshift != 0).any(axis=0))
            for c in range(n):
                if not _is_permutation(a[c], nprocs):
                    _count("fold_fallbacks", 1)
                    continue
                agrid = a[c].reshape(sched.grid)
                periods = {ax: self._axis_period(agrid, ax) for ax in axes}
                # Slabs fold together when they share a class and their
                # shifts agree modulo the candidate's per-axis periods.
                cols = [frep] + [fshift[:, ax] % periods[ax] for ax in axes]
                _, inverse = np.unique(np.stack(cols, axis=1), axis=0,
                                       return_inverse=True)
                inverse = inverse.reshape(-1)
                first = np.full(int(inverse.max()) + 1, u, dtype=np.int64)
                np.minimum.at(first, inverse, slab_ids)
                rep[c] = first[inverse]
                if (rep[c] != frep).any():
                    _count("fold_fallbacks", 1)
        if incremental and n > 1:
            changed = a[1:] != a[:1]
            for c in range(1, n):
                mask = changed[c - 1]
                if mask.all():
                    continue
                if not mask.any():
                    unch[c] = True
                    continue
                moved = mask[sched.src] | mask[sched.dst]
                unch[c] = np.bincount(sched.phase_id[moved],
                                      minlength=u) == 0
        sizes = np.diff(sched.starts)
        need = (rep == slab_ids[None, :]) & ~unch & (sizes > 0)[None, :]
        _count("pairs_priced", int(need.sum()))
        _count("pairs_folded", int((rep != slab_ids[None, :]).sum()))
        _count("pairs_reused",
               int((unch & (rep == slab_ids[None, :])).sum()))
        return rep, unch, need

    def _gather_pairs(self, a: np.ndarray, cc: np.ndarray, ss: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, int]:
        """Endpoint/bucket arrays pricing the ``(cc, ss)`` candidate/slab
        pairs: one bucket per pair, transfers in slab order (the same
        accumulation order as the dense all-pairs pass, so the priced
        values are bit-identical)."""
        sched = self.schedule
        sizes = np.diff(sched.starts)[ss]
        total = int(sizes.sum())
        cand = np.repeat(cc, sizes)
        t_idx = (np.repeat(sched.starts[:-1][ss], sizes)
                 + np.arange(total, dtype=np.int64)
                 - np.repeat(np.cumsum(sizes) - sizes, sizes))
        src = a[cand, sched.src[t_idx]]
        dst = a[cand, sched.dst[t_idx]]
        bucket = np.repeat(np.arange(cc.size, dtype=np.int64), sizes)
        return src, dst, sched.nbytes[t_idx], bucket, int(cc.size)

    def _fill_slabs(self, rep: np.ndarray, unch: np.ndarray,
                    need: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Re-expand priced pair values to the full (N, n_unique) slab
        times: scatter, resolve the base row's folds, copy base-identical
        slabs, then broadcast every row's translation folds."""
        n, u = need.shape
        times = np.zeros((n, u), dtype=np.float64)
        times[need] = values
        times[0] = times[0][rep[0]]
        if n > 1:
            times = np.where(unch, times[0][None, :], times)
            times = np.take_along_axis(times, rep, axis=1)
        return times

    def phase_durations(self, assignments: np.ndarray, *,
                        fold: bool = True,
                        incremental: bool = True) -> np.ndarray:
        """(N, n_phases) congestion-priced phase times, all candidates in
        one bucketed pass. Only the schedule's *unique* transfer slabs
        are priced (repeated rounds broadcast back over ``phase_map``),
        and of those only one translation representative per candidate
        symmetry class (``fold``) and only the slabs whose placements
        differ from candidate 0's (``incremental``) — both copies are
        bit-exact, so disabling the flags changes nothing but speed.
        Gathers are chunked to bound peak memory."""
        a = self._flat_assignments(assignments)
        n, sched = a.shape[0], self.schedule
        u, t = sched.n_unique, sched.n_transfers
        if t == 0 or n == 0 or sched.n_phases == 0:
            return np.zeros((n, sched.n_phases), dtype=np.float64)
        rep, unch, need = self._plan(a, fold, incremental)
        cc, ss = np.nonzero(need)
        values = np.empty(cc.size, dtype=np.float64)
        sizes = np.diff(sched.starts)[ss]
        for lo, hi in _chunk_pairs(sizes, _MAX_GATHER_ELEMS):
            src, dst, nbytes, bucket, nb = self._gather_pairs(
                a, cc[lo:hi], ss[lo:hi])
            values[lo:hi] = self.topology.bucket_times(
                src, dst, nbytes, bucket, nb)
        slab_times = self._fill_slabs(rep, unch, need, values)
        return slab_times[:, sched.phase_map]

    def _close_steps(self, durations: np.ndarray) -> np.ndarray:
        """(N, n_phases) phase durations -> (N,) steady-state step times:
        the closed form of ``simulate_steps(...).per_step_time()`` for a
        constant schedule (cumsum matches the event engine's sequential
        accumulation on the serial network stream)."""
        if durations.shape[1] == 0:
            comm = np.zeros(durations.shape[0], dtype=np.float64)
        else:
            comm = np.cumsum(durations, axis=1)[:, -1]
        if self.steps == 1 or self.backpressure == 1:
            return self.compute_s + comm
        return np.maximum(self.compute_s, comm)

    def step_times(self, assignments: np.ndarray, *, fold: bool = True,
                   incremental: bool = True) -> np.ndarray:
        """(N,) steady-state seconds per step — the closed form of
        ``simulate_steps(...).per_step_time()`` for a constant schedule."""
        return self._close_steps(self.phase_durations(
            assignments, fold=fold, incremental=incremental))

    def step_time(self, assignment: np.ndarray) -> float:
        """Seconds per step of a single placement."""
        return float(self.step_times(
            np.asarray(assignment, dtype=np.int64).reshape(1, -1))[0])

    def step_times_async(self, assignments: np.ndarray, *,
                         fold: bool = True,
                         incremental: bool = True) -> ReadyPrices:
        """Asynchronous-dispatch twin of :meth:`step_times`: returns a
        handle whose ``result()`` yields the (N,) step times. The host
        engine computes eagerly (NumPy has no deferred execution — but
        its pricing releases the GIL, so a pipeline's producer thread
        still overlaps it); the torch engine overrides this to launch
        the pricing on the card and return before the device finishes."""
        return ReadyPrices(self.step_times(
            assignments, fold=fold, incremental=incremental))


def price_stacks(stacks: Sequence[tuple["BatchSimulator", np.ndarray]],
                 *, fold: bool = True,
                 incremental: bool = True) -> list[np.ndarray]:
    """Step times for several (engine, assignment-stack) groups in as few
    congestion passes as possible.

    The bucket axis of :meth:`Topology.bucket_times` does not care that
    different buckets came from different schedules, so a whole tuner
    beam — every shortlisted grid's surviving variants, across option
    points — prices in one ``candidates x phases x ports`` sweep as long
    as the groups share a topology. Each group is first *planned*
    (:meth:`BatchSimulator._plan`): symmetry-folded and base-identical
    slabs are dropped from the gather and reconstructed bit-exactly
    afterwards, so only the irreducible pairs hit the congestion pass.
    Groups are greedily packed into passes bounded by the gather ceiling;
    an oversized single group falls back to its own (internally chunked)
    :meth:`BatchSimulator.step_times`.
    """
    out: list[np.ndarray | None] = [None] * len(stacks)
    prepared: list[tuple] = []
    for i, (engine, assigns) in enumerate(stacks):
        if getattr(engine, "prices_independently", False):
            # Device-resident engines (repro_torch.sim.torch_backend) price
            # each stack as its own chunked launches; concatenating their
            # transfers into the shared NumPy congestion pass would force
            # the data back to the host.
            out[i] = engine.step_times(assigns, fold=fold,
                                       incremental=incremental)
            continue
        a = engine._flat_assignments(assigns)
        sched = engine.schedule
        if (a.shape[0] == 0 or sched.n_phases == 0
                or sched.n_transfers == 0
                or a.shape[0] * sched.n_transfers > _MAX_GATHER_ELEMS):
            out[i] = engine.step_times(a, fold=fold, incremental=incremental)
            continue
        rep, unch, need = engine._plan(a, fold, incremental)
        cc, ss = np.nonzero(need)
        elems = int(np.diff(sched.starts)[ss].sum())
        prepared.append((i, a, rep, unch, need, cc, ss, elems))
    runs: list[list[int]] = []
    run: list[int] = []
    run_elems = 0
    for j, item in enumerate(prepared):
        engine = stacks[item[0]][0]
        same_topo = (not run or stacks[prepared[run[0]][0]][0].topology
                     == engine.topology)
        if run and (run_elems + item[-1] > _MAX_GATHER_ELEMS
                    or not same_topo):
            runs.append(run)
            run, run_elems = [], 0
        run.append(j)
        run_elems += item[-1]
    if run:
        runs.append(run)
    for run in runs:
        topo = stacks[prepared[run[0]][0]][0].topology
        srcs, dsts, nbs, buckets = [], [], [], []
        offs = []
        total = 0
        for j in run:
            i, a, rep, unch, need, cc, ss, _ = prepared[j]
            engine = stacks[i][0]
            src, dst, nb, bucket, npairs = engine._gather_pairs(a, cc, ss)
            srcs.append(src)
            dsts.append(dst)
            nbs.append(nb)
            buckets.append(bucket + total)
            offs.append((j, total, npairs))
            total += npairs
        times = topo.bucket_times(
            np.concatenate(srcs) if srcs else np.empty(0, np.int64),
            np.concatenate(dsts) if dsts else np.empty(0, np.int64),
            np.concatenate(nbs) if nbs else np.empty(0, np.float64),
            np.concatenate(buckets) if buckets else np.empty(0, np.int64),
            total,
        )
        for j, off, npairs in offs:
            i, a, rep, unch, need, cc, ss, _ = prepared[j]
            engine = stacks[i][0]
            slab_times = engine._fill_slabs(rep, unch, need,
                                            times[off:off + npairs])
            out[i] = engine._close_steps(
                slab_times[:, engine.schedule.phase_map])
    return [np.asarray(o) for o in out]


def iter_price_stacks(stacks: Sequence[tuple["BatchSimulator", np.ndarray]],
                      *, fold: bool = True,
                      incremental: bool = True
                      ) -> Iterator[tuple[int, np.ndarray]]:
    """Streaming entry point: yield ``(index, step_times)`` per group as
    each finishes, dispatching every group asynchronously up front.

    Where :func:`price_stacks` is a strict barrier (nothing returns until
    the whole beam is priced), this generator lets a consumer merge
    results group by group while later groups are still pricing — on the
    torch engine the launches queue on the device and the host only
    blocks per-group at ``result()``. Values are identical to
    :func:`price_stacks` (each group prices from its own endpoint
    arrays into independent buckets; packing groups together never
    changed the arithmetic). The tuner's pipelined Phase 3
    (``repro_torch.search.pipeline``) is the primary consumer.
    """
    handles = [
        (i, engine.step_times_async(assigns, fold=fold,
                                    incremental=incremental))
        for i, (engine, assigns) in enumerate(stacks)
    ]
    for i, handle in handles:
        yield i, np.asarray(handle.result())


def batch_simulator(pattern: CollectivePattern, spec: MachineSpec,
                    grid: Sequence[int], *, step_flops: float,
                    elem_bytes: int = 4, backpressure: int = 2,
                    steps: int = 3,
                    alphas: tuple[float, ...] | None = None,
                    degraded: "DegradedMachine | None" = None
                    ) -> BatchSimulator:
    """Build the batch engine for one (pattern, machine, grid) point:
    memoized packed schedule + topology + the app's compute leg."""
    grid = tuple(int(g) for g in grid)
    return BatchSimulator(
        topology=Topology.from_spec(spec, alphas=alphas, degraded=degraded),
        schedule=packed_schedule(pattern, grid, elem_bytes=elem_bytes),
        compute_s=float(step_flops) / (spec.nprocs * spec.peak_flops),
        backpressure=backpressure,
        steps=steps,
    )


# ------------------------------------------------------------------ symmetry
def canonical_assignment(assignment: np.ndarray,
                         machine_shape: Sequence[int]) -> np.ndarray:
    """The representative of a placement's isomorphism class under
    per-level processor relabeling.

    Nodes are renumbered in order of first appearance (row-major over the
    tile grid), then processors within each node likewise. Two placements
    with equal canonical forms put identical byte loads on every port of
    the level tree — crossing levels depend only on the *equality
    pattern* of coordinates and each level's ports share one bandwidth —
    so their simulated times and cross-node fractions coincide and the
    tuner prices one representative.
    """
    nodes, gpus = (int(s) for s in machine_shape)
    flat = np.asarray(assignment, dtype=np.int64).reshape(-1)
    node, gpu = flat // gpus, flat % gpus
    new_node = _appearance_rank(node)
    # Within-node relabeling: rank each (node, gpu) pair by its first
    # appearance among the pairs of the same (relabeled) node.
    pair = new_node * gpus + gpu
    uniq, first = np.unique(pair, return_index=True)
    seg_node = uniq // gpus
    order = np.lexsort((first, seg_node))
    seg_start = np.r_[0, np.flatnonzero(np.diff(seg_node[order])) + 1]
    sizes = np.diff(np.r_[seg_start, uniq.size])
    pos = np.arange(uniq.size) - np.repeat(seg_start, sizes)
    new_gpu_of_uniq = np.empty(uniq.size, dtype=np.int64)
    new_gpu_of_uniq[order] = pos
    new_gpu = new_gpu_of_uniq[np.searchsorted(uniq, pair)]
    return (new_node * gpus + new_gpu).reshape(np.asarray(assignment).shape)


def _appearance_rank(values: np.ndarray) -> np.ndarray:
    """Relabel integer values by order of first appearance."""
    uniq, first = np.unique(values, return_index=True)
    ranks = np.empty(uniq.size, dtype=np.int64)
    ranks[np.argsort(first)] = np.arange(uniq.size)
    return ranks[np.searchsorted(uniq, values)]


__all__ = [
    "BatchSimulator",
    "FOLD_STATS",
    "FOLD_STAT_KEYS",
    "ReadyPrices",
    "batch_simulator",
    "canonical_assignment",
    "fold_stats",
    "fold_stats_reset",
    "fold_stats_snapshot",
    "iter_price_stacks",
    "price_stacks",
]
