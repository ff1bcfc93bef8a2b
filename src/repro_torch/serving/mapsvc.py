"""Mapping-as-a-service: a persistent, concurrent tuning server.

The batch CLI (``repro_torch.apps.run --tune --time``) answers one mapping
question per process; this module keeps the tuner resident and answers a
*stream* of them. A :class:`MappingService` accepts
:class:`TuneRequest`\\ s ("map app X on machine M at scale N, priced on
engine E"), and resolves each to a :class:`MappingPlan` (winner IR +
rendered Mapple source + leaderboard + provenance) or a typed
:class:`Rejected`. Four mechanisms make the resident form pay:

* **Plan cache** (:mod:`repro_torch.serving.plan_cache`): the winner of every
  search is stored under a digest of ``(app, procs, machine spec,
  value-tag, search knobs)``. An exact repeat resolves from the cache
  with *zero* recomputation — no Phase 1, no pricing — and the
  append-only file under ``cache_dir/plans`` makes hits survive
  restarts and cross processes.
* **Warm-started search**: a near-miss (same app, different scale) seeds
  the beam with cached winners re-instantiated on the new grid
  (:func:`~repro_torch.search.tuner.refit_candidate`). Seeds *widen* the beam
  (superset of the cold shortlist), so a warm search is never worse
  than cold, and bit-identical to it when no seed is novel.
* **Admission + priority scheduling**: a bounded queue ordered by
  ``(priority, deadline)``; overload sheds with
  ``Rejected("queue-full")`` at submit, expired deadlines shed at
  dispatch, per-request timeouts report ``Rejected("timeout")``.
* **Cross-request batched pricing**: each drained batch coalesces
  identical keys to one search and prices *all* its searches' Phase-3
  candidate stacks in a single
  :func:`~repro_torch.search.pipeline.price_jobs` call — jobs from different
  requests pack into shared ``BatchSimulator.price_stacks`` congestion
  passes.

``workers=0`` runs the service inline: callers submit, then
:meth:`MappingService.drain` processes the queue on the calling thread
(deterministic, the test/benchmark mode). ``workers>=1`` starts daemon
threads that drain continuously. Either way the tuner itself is
deterministic, so concurrent submission yields plans bit-identical to
serial runs.

The counterpart of ``repro.serving.mapsvc``. Its ``"batched-torch"``
engine prices on the service's ``device`` (the card by default, through
the hand-written ``segment_rowmax`` kernel); without a card that engine
refuses to build, and the service answers such a request with
``Rejected("error")`` — it never prices on the CPU or on another engine
instead.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Sequence

from repro_torch.search.space import Candidate
from repro_torch.search.tuner import (
    DEFAULT_BEAM,
    DEFAULT_LEADERBOARD,
    prepare_tune,
    refit_candidate,
)
from repro_torch.search.pipeline import price_jobs
from repro_torch.search.remap import remap_plan
from repro_torch.serving.plan_cache import PlanCache, plan_key
from repro_torch.serving.stats import ServiceStats
from repro_torch.sim.cost import (
    DEFAULT_ELEM_BYTES,
    DEFAULT_STEPS,
    spec_for,
    time_tuned_app,
)
from repro_torch.sim.price_cache import PriceCache

#: Default admission-queue bound (submits past it shed immediately).
DEFAULT_QUEUE_LIMIT = 64
#: Default max requests drained (and cross-priced) per batch.
DEFAULT_COALESCE = 8


def value_tag(engine: str, dtype: str = "float64") -> str:
    """The pricing value family of an (engine, dtype) pair — mirrors
    ``SimulatedTimeCostModel.value_tag`` without building a model, so
    plan-cache keys are computable before any search machinery exists."""
    if engine == "batched-torch":
        return "torch-f32" if dtype == "float32" else "torch-f64"
    return "event-f64" if engine == "event" else "numpy-f64"


@dataclasses.dataclass(frozen=True)
class TuneRequest:
    """One mapping question.

    ``engine``/``dtype`` default to the service's; ``machine_shape``
    overrides the app registry's shape for ``procs``; ``priority`` sorts
    ascending (0 before 1); ``deadline_s`` (relative to submit) sheds
    the request if it has not *started* by then; ``timeout_s`` bounds
    end-to-end latency post-hoc (the plan is still cached)."""

    app: str
    procs: int | None = None
    machine_shape: tuple[int, ...] | None = None
    engine: str | None = None
    dtype: str | None = None
    priority: int = 0
    deadline_s: float | None = None
    timeout_s: float | None = None


@dataclasses.dataclass(frozen=True)
class RemapRequest:
    """A recovery question: processors failed under a running plan —
    re-place the work on the survivors, *now*.

    ``failures`` is anything
    :func:`~repro_torch.search.remap.degraded_from_failures` accepts (a
    ``DegradedMachine``, ``NodeFailure``\\ s, node-death ``FaultEvent``\\ s,
    bare processor ids). The default ``priority=-1`` sorts remaps ahead
    of every routine tune in the admission heap — a cluster bleeding
    step time outranks speculative what-if tuning. ``mode`` picks the
    warm restricted search (default) or the full cold baseline."""

    app: str
    failures: object
    procs: int | None = None
    machine_shape: tuple[int, ...] | None = None
    engine: str | None = None
    dtype: str | None = None
    mode: str = "warm"
    priority: int = -1
    deadline_s: float | None = None
    timeout_s: float | None = None


@dataclasses.dataclass
class MappingPlan:
    """A resolved mapping: the tuner's winner plus service provenance.

    ``provenance`` is ``"cache"`` (exact plan-cache hit, zero search),
    ``"warm"`` (searched with cached seeds in the beam) or ``"cold"``
    (searched from scratch). ``payload()``/``from_payload()`` are the
    plan-cache serialization — JSON-stable, so cached plans round-trip
    across processes byte-for-byte."""

    app: str
    procs: int
    machine_shape: tuple[int, ...]
    value_tag: str
    candidate: dict                    # grid/dist/order/options of the winner
    placed_cost: float | None
    volume: float
    source: str                        # rendered Mapple DSL program
    ir: str                            # winner's mapper IR description
    verified: bool
    leaderboard: list                  # ScoredCandidate.row() dicts
    provenance: str = "cold"
    warm_seeds: int = 0
    elapsed_s: float = 0.0
    timings: dict = dataclasses.field(default_factory=dict)
    #: Recovery facts when this plan answered a :class:`RemapRequest`
    #: (``provenance == "remap"``): sub_shape, proc_map, the physical
    #: placement, and degraded/stale step times. ``None`` for routine
    #: tunes; never part of the cached payload (a remap answers one
    #: concrete failure, not the app x procs question the cache keys).
    remap: dict | None = None

    def payload(self) -> dict:
        """The JSON-serializable plan-cache record (provenance and
        timings are per-request facts, not part of the plan)."""
        return {
            "app": self.app,
            "procs": int(self.procs),
            "machine_shape": list(self.machine_shape),
            "value_tag": self.value_tag,
            "candidate": dict(self.candidate),
            "placed_cost": self.placed_cost,
            "volume": self.volume,
            "source": self.source,
            "ir": self.ir,
            "verified": self.verified,
            "leaderboard": [dict(r) for r in self.leaderboard],
        }

    @classmethod
    def from_payload(cls, payload: dict, *, provenance: str,
                     elapsed_s: float = 0.0,
                     timings: dict | None = None) -> "MappingPlan":
        return cls(
            app=payload["app"],
            procs=int(payload["procs"]),
            machine_shape=tuple(int(s) for s in payload["machine_shape"]),
            value_tag=payload["value_tag"],
            candidate=dict(payload["candidate"]),
            placed_cost=payload.get("placed_cost"),
            volume=float(payload["volume"]),
            source=payload["source"],
            ir=payload["ir"],
            verified=bool(payload["verified"]),
            leaderboard=[dict(r) for r in payload.get("leaderboard", [])],
            provenance=provenance,
            warm_seeds=0,
            elapsed_s=elapsed_s,
            timings=dict(timings or {}),
        )

    def summary(self) -> dict:
        out = self.payload()
        out.update(provenance=self.provenance, warm_seeds=self.warm_seeds,
                   elapsed_s=self.elapsed_s, timings=dict(self.timings))
        if self.remap is not None:
            out["remap"] = dict(self.remap)
        return out


@dataclasses.dataclass(frozen=True)
class Rejected:
    """A typed non-answer. ``reason`` is one of ``"queue-full"``,
    ``"deadline"``, ``"timeout"``, ``"error"``, ``"closed"``."""

    reason: str
    detail: str = ""
    app: str = ""


class Ticket:
    """The caller's handle on one submitted request."""

    def __init__(self, request: "TuneRequest | RemapRequest",
                 submit_t: float) -> None:
        self.request = request
        self.submit_t = submit_t
        self._event = threading.Event()
        self._result: "MappingPlan | Rejected | None" = None
        self._requeued = False         # one free retry after a worker crash

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> "MappingPlan | Rejected":
        """Block until resolved; raises ``TimeoutError`` if ``timeout``
        elapses first (the request itself keeps running)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request for {self.request.app!r} still pending")
        assert self._result is not None
        return self._result


def _candidate_from(payload: dict) -> Candidate | None:
    """Rebuild a Candidate from a plan payload's ``candidate`` dict;
    ``None`` on malformed/stale payloads (skipped, never fatal)."""
    try:
        return Candidate(
            grid=tuple(int(g) for g in payload["grid"]),
            dist=tuple(str(d) for d in payload["dist"]),
            order=tuple(int(o) for o in payload["order"]),
            options=tuple((str(k), str(v)) for k, v in payload["options"]),
        )
    except (KeyError, TypeError, ValueError):
        return None


def plan_from_report(report, *, value_tag_: str, provenance: str,
                     timings: dict | None = None) -> MappingPlan:
    """Fold a :class:`~repro_torch.search.tuner.TuningReport` into the service's
    plan shape (also used by the batch CLI's ``--warm-start-from``)."""
    best = report.best.candidate
    return MappingPlan(
        app=report.app,
        procs=report.procs,
        machine_shape=tuple(report.machine_shape),
        value_tag=value_tag_,
        candidate={
            "grid": list(best.grid),
            "dist": list(best.dist),
            "order": list(best.order),
            "options": [[k, v] for k, v in best.options],
        },
        placed_cost=report.best.placed_cost,
        volume=report.best.volume,
        source=report.best_source,
        ir=report.best_ir,
        verified=report.verified,
        leaderboard=[s.row() for s in report.leaderboard],
        provenance=provenance,
        warm_seeds=report.warm_seeds,
        elapsed_s=report.elapsed_s,
        timings=dict(timings or {}),
    )


def plan_key_for(tuned_app, procs: int | None = None, *, engine: str,
                 dtype: str = "float64", beam: int = DEFAULT_BEAM,
                 steps: int = DEFAULT_STEPS,
                 elem_bytes: int = DEFAULT_ELEM_BYTES
                 ) -> tuple[int, bytes, str]:
    """Resolve one (app, procs) question to its plan-cache coordinates:
    ``(resolved procs, key digest, value tag)``. The procs fallback
    matches the tuner's, so the key always names the scale the report
    will actually carry. Shared by the service and the batch CLI's
    ``--warm-start-from`` — one on-disk format."""
    space = tuned_app.search_space
    n = tuned_app.procs(procs)
    if space is not None and not space.grids(n):
        n = tuned_app.default_procs   # same fallback the tuner applies
    shape = tuple(int(s) for s in tuned_app.machine_shape(n))
    tag = value_tag(engine, dtype)
    key = plan_key(tuned_app.name, n, repr(spec_for(shape)), tag,
                   knobs=(beam, steps, elem_bytes))
    return n, key, tag


def warm_seeds_for(plans: PlanCache, app_name: str, procs: int, space, *,
                   exclude: bytes | None = None,
                   count: int = 2) -> list[Candidate]:
    """Cached winners for ``app_name`` nearest in scale to ``procs``,
    refit onto the live space's feasible grids — ``tune_app``'s
    ``warm_start`` argument, straight from a plan cache. Malformed or
    incompatible payloads are skipped."""
    seeds = []
    for payload in plans.nearest(app_name, procs, count=count,
                                 exclude=exclude):
        cand = _candidate_from(payload.get("candidate", {}))
        if cand is None:
            continue
        refit = refit_candidate(space, cand, procs)
        if refit is not None:
            seeds.append(refit)
    return seeds


class MappingService:
    """The resident tuning server. See the module docstring for the
    architecture; every public method is thread-safe."""

    def __init__(self, cache_dir: str | Path | None = None, *,
                 engine: str = "batched", dtype: str = "float64",
                 beam: int = DEFAULT_BEAM,
                 leaderboard: int = DEFAULT_LEADERBOARD,
                 steps: int = DEFAULT_STEPS,
                 elem_bytes: int = DEFAULT_ELEM_BYTES,
                 workers: int = 1,
                 queue_limit: int = DEFAULT_QUEUE_LIMIT,
                 coalesce: int = DEFAULT_COALESCE,
                 warm_start: bool = True,
                 store: bool = True,
                 device: str = "cuda") -> None:
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if coalesce < 1:
            raise ValueError(f"coalesce must be >= 1, got {coalesce}")
        root = Path(cache_dir) if cache_dir is not None else None
        self.engine = engine
        self.dtype = dtype
        self.device = device
        self.beam = beam
        self.leaderboard = leaderboard
        self.steps = steps
        self.elem_bytes = elem_bytes
        self.queue_limit = queue_limit
        self.coalesce = coalesce
        self.warm_start = warm_start
        self.store = store
        self.plans = PlanCache(None if root is None else root / "plans")
        self.prices = (PriceCache(root / "prices")
                       if root is not None else None)
        self.stats = ServiceStats()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._heap: list = []          # (priority, deadline, seq, ticket)
        self._seq = itertools.count()
        self._closed = False
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name=f"mapsvc-worker-{i}", daemon=True)
            for i in range(max(workers, 0))
        ]
        for t in self._workers:
            t.start()

    # ------------------------------------------------------------- frontend
    def submit(self, request: "TuneRequest | RemapRequest") -> Ticket:
        """Enqueue one request. Always returns a ticket; admission
        control resolves it immediately with ``Rejected("queue-full")``
        or ``Rejected("closed")`` when the service cannot take it."""
        now = time.perf_counter()
        ticket = Ticket(request, now)
        with self._work:
            self.stats.submitted += 1
            if self.stats.first_submit_t is None:
                self.stats.first_submit_t = now
            if self._closed:
                self._resolve_locked(
                    ticket, Rejected("closed", "service closed", request.app))
            elif len(self._heap) >= self.queue_limit:
                self._resolve_locked(
                    ticket,
                    Rejected("queue-full",
                             f"admission queue at limit {self.queue_limit}",
                             request.app))
            else:
                deadline = (now + request.deadline_s
                            if request.deadline_s is not None
                            else float("inf"))
                heapq.heappush(
                    self._heap,
                    (request.priority, deadline, next(self._seq), ticket))
                self._work.notify()
        return ticket

    def map(self, request: TuneRequest,
            timeout: float | None = None) -> "MappingPlan | Rejected":
        """Submit-and-wait convenience. With ``workers=0`` the caller's
        thread drains the queue itself."""
        ticket = self.submit(request)
        if not self._workers:
            self.drain()
        return ticket.result(timeout)

    def drain(self) -> int:
        """Process the queue on the calling thread until empty; returns
        requests resolved. The ``workers=0`` mode — deterministic batch
        boundaries for tests and benchmarks."""
        resolved = 0
        while True:
            batch = self._take_batch(block=False)
            if not batch:
                return resolved
            resolved += len(batch)
            self._process_guarded(batch)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Stop accepting, let workers finish the queue, join them. The
        remaining queue is drained inline when there are no workers."""
        with self._work:
            if self._closed:
                return
            self._closed = True
            self._work.notify_all()
        for t in self._workers:
            t.join()
        if not self._workers:
            self.drain()

    def __enter__(self) -> "MappingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ scheduling
    def _resolve_locked(self, ticket: Ticket,
                        result: "MappingPlan | Rejected") -> None:
        now = time.perf_counter()
        self.stats.last_resolve_t = now
        if isinstance(result, Rejected):
            self.stats.note_rejected(result.reason)
        else:
            self.stats.completed += 1
            self.stats.latencies.append(now - ticket.submit_t)
        ticket._result = result
        ticket._event.set()

    def _resolve(self, ticket: Ticket,
                 result: "MappingPlan | Rejected") -> None:
        with self._lock:
            self._resolve_locked(ticket, result)

    def _take_batch(self, block: bool) -> list[Ticket]:
        """Pop up to ``coalesce`` requests in (priority, deadline, FIFO)
        order, shedding any whose deadline already passed. Blocks for
        work when ``block`` (worker mode) unless closing."""
        with self._work:
            while True:
                now = time.perf_counter()
                batch: list[Ticket] = []
                while self._heap and len(batch) < self.coalesce:
                    _, deadline, _, ticket = heapq.heappop(self._heap)
                    if now > deadline:
                        self._resolve_locked(
                            ticket,
                            Rejected("deadline",
                                     "deadline expired before dispatch",
                                     ticket.request.app))
                        continue
                    batch.append(ticket)
                if batch or not block:
                    return batch
                if self._closed:
                    return []
                self._work.wait(timeout=0.1)

    def _worker_loop(self) -> None:
        while True:
            batch = self._take_batch(block=True)
            if not batch:
                return                  # closed and queue empty
            self._process_guarded(batch)

    def _process_guarded(self, batch: list[Ticket]) -> None:
        """Run one batch, surviving a crash of the processing code
        itself (``_process`` catches per-request errors into typed
        ``Rejected``\\ s; this guard catches everything it could not —
        the "worker thread dies" case). Each still-unresolved ticket is
        requeued exactly once; a second crash resolves it with
        ``Rejected("error")`` so callers never hang on a dropped
        request."""
        try:
            self._process(batch)
        except BaseException as exc:  # noqa: BLE001 - survive the worker
            with self._work:
                self.stats.worker_crashes += 1
                for ticket in batch:
                    if ticket.done:
                        continue
                    if ticket._requeued:
                        self._resolve_locked(ticket, Rejected(
                            "error",
                            f"worker crashed twice on this request: {exc}",
                            ticket.request.app))
                        continue
                    ticket._requeued = True
                    deadline = (ticket.submit_t + ticket.request.deadline_s
                                if ticket.request.deadline_s is not None
                                else float("inf"))
                    heapq.heappush(
                        self._heap,
                        (ticket.request.priority, deadline,
                         next(self._seq), ticket))
                self._work.notify_all()

    # ------------------------------------------------------------- resolve
    def _request_key(self, request: TuneRequest):
        """Canonicalize one request: the tuned app object, resolved
        procs, machine shape, value tag and the plan-cache digest."""
        from repro_torch import apps

        engine = request.engine or self.engine
        dtype = request.dtype or self.dtype
        app = apps.get(request.app)
        if request.machine_shape is not None:
            shape_over = tuple(int(s) for s in request.machine_shape)
            app = dataclasses.replace(
                app, machine_shape=lambda p, s=shape_over: s)
        tuned = time_tuned_app(app, steps=self.steps,
                               elem_bytes=self.elem_bytes, engine=engine,
                               dtype=dtype, device=self.device,
                               cache=self.prices)
        n, key, tag = plan_key_for(tuned, request.procs, engine=engine,
                                   dtype=dtype, beam=self.beam,
                                   steps=self.steps,
                                   elem_bytes=self.elem_bytes)
        shape = tuple(int(s) for s in tuned.machine_shape(n))
        return tuned, n, shape, tag, key

    def _seeds(self, app_name: str, procs: int, space,
               exclude: bytes) -> list[Candidate]:
        if not self.warm_start:
            return []
        return warm_seeds_for(self.plans, app_name, procs, space,
                              exclude=exclude)

    def _remap(self, ticket: Ticket) -> None:
        """Serve one :class:`RemapRequest`: look up the stale winner and
        nearby cached plans as seeds, run the (restricted, warm)
        :func:`~repro_torch.search.remap.remap_plan` search, and resolve the
        ticket with a ``provenance="remap"`` plan carrying the physical
        placement and recovery audit numbers. Remap plans are never
        stored — they answer one concrete failure, not the cache's
        (app, procs) question."""
        req = ticket.request
        t_start = time.perf_counter()
        try:
            from repro_torch import apps

            engine = req.engine or self.engine
            dtype = req.dtype or self.dtype
            app = apps.get(req.app)
            if req.machine_shape is not None:
                shape_over = tuple(int(s) for s in req.machine_shape)
                app = dataclasses.replace(
                    app, machine_shape=lambda p, s=shape_over: s)
            tuned = time_tuned_app(app, steps=self.steps,
                                   elem_bytes=self.elem_bytes, engine=engine,
                                   dtype=dtype, device=self.device,
                                   cache=self.prices)
            n0, key, tag = plan_key_for(tuned, req.procs, engine=engine,
                                        dtype=dtype, beam=self.beam,
                                        steps=self.steps,
                                        elem_bytes=self.elem_bytes)
            stale_payload = self.plans.get(key)
            stale = (_candidate_from(stale_payload.get("candidate", {}))
                     if stale_payload is not None else None)
            seeds: list[Candidate] = []
            if self.warm_start:
                for payload in self.plans.nearest(app.name, n0, count=2,
                                                  exclude=key):
                    cand = _candidate_from(payload.get("candidate", {}))
                    if cand is not None:
                        seeds.append(cand)
            result = remap_plan(
                app, stale, req.failures, seeds=seeds, mode=req.mode,
                engine=engine, dtype=dtype, cache=self.prices,
                beam=self.beam, leaderboard=self.leaderboard,
                steps=self.steps, elem_bytes=self.elem_bytes,
                procs=req.procs, device=self.device)
        except Exception as exc:  # noqa: BLE001 - typed rejection
            self._resolve(ticket, Rejected("error", str(exc), req.app))
            return
        search_s = time.perf_counter() - t_start
        summary = result.summary()
        plan = dataclasses.replace(
            plan_from_report(result.report, value_tag_=value_tag(engine,
                                                                 dtype),
                             provenance="remap",
                             timings={"search_s": search_s}),
            remap={k: summary[k] for k in (
                "mode", "n_alive", "sub_shape", "proc_map", "placement",
                "degraded_step_s", "stale_step_s")})
        with self._lock:
            self.stats.remaps += 1
            self.stats.searches += 1
            self.stats.search_s.append(search_s)
            if result.report.warm_seeds:
                self.stats.warm += 1
            else:
                self.stats.cold += 1
        elapsed = time.perf_counter() - ticket.submit_t
        if req.timeout_s is not None and elapsed > req.timeout_s:
            self._resolve(ticket, Rejected(
                "timeout",
                f"resolved in {elapsed:.3f}s > budget {req.timeout_s}s",
                req.app))
            return
        self._resolve(ticket, dataclasses.replace(plan, elapsed_s=elapsed))

    def _process(self, batch: list[Ticket]) -> None:
        """Resolve one drained batch: remaps first (they outrank and
        never coalesce — each answers a distinct failure), then exact
        cache hits answer immediately; the rest coalesce by key, search
        Phases 1–2 each, then price *every* search's Phase-3 jobs in
        one shared ``price_jobs`` sweep before finishing Phase 4 per
        key."""
        groups: dict[bytes, list] = {}   # key -> [tuned, n, tag, tickets]
        for ticket in batch:
            if isinstance(ticket.request, RemapRequest):
                self._remap(ticket)
                continue
            req = ticket.request
            t_cache = time.perf_counter()
            try:
                tuned, n, _shape, tag, key = self._request_key(req)
                payload = self.plans.get(key)
            except Exception as exc:  # noqa: BLE001 - typed rejection
                self._resolve(ticket, Rejected("error", str(exc), req.app))
                continue
            now = time.perf_counter()
            with self._lock:
                self.stats.wait_s.append(t_cache - ticket.submit_t)
                self.stats.cache_s.append(now - t_cache)
            if payload is not None:
                with self._lock:
                    self.stats.cache_hits += 1
                self._resolve(ticket, MappingPlan.from_payload(
                    payload, provenance="cache",
                    elapsed_s=now - ticket.submit_t,
                    timings={"cache_s": now - t_cache}))
                continue
            group = groups.setdefault(key, [tuned, n, tag, []])
            group[3].append(ticket)

        if not groups:
            return

        # Phases 1-2 per unique key; Phase 3 jobs pooled across keys.
        pendings: dict[bytes, tuple] = {}
        all_jobs, job_spans = [], []
        for key, (tuned, n, tag, tickets) in groups.items():
            t_search = time.perf_counter()
            try:
                seeds = self._seeds(tuned.name, n, tuned.search_space, key)
                pending = prepare_tune(tuned, n, beam=self.beam,
                                       leaderboard=self.leaderboard,
                                       warm_start=seeds)
                jobs = list(pending.jobs())
            except Exception as exc:  # noqa: BLE001 - typed rejection
                for ticket in tickets:
                    self._resolve(ticket, Rejected("error", str(exc),
                                                   ticket.request.app))
                continue
            start = len(all_jobs)
            all_jobs.extend(jobs)
            job_spans.append((key, t_search, start, len(all_jobs)))
            pendings[key] = (pending, tuned, n, tag, tickets)

        if not pendings:
            return
        t3 = time.perf_counter()
        try:
            price_jobs(all_jobs)      # ONE sweep across every request
        except Exception as exc:  # noqa: BLE001 - typed rejection
            for pending, _, _, _, tickets in pendings.values():
                for ticket in tickets:
                    self._resolve(ticket, Rejected("error", str(exc),
                                                   ticket.request.app))
            return
        with self._lock:
            if all_jobs:
                self.stats.shared_pricing_passes += 1

        for key, t_search, _, _ in job_spans:
            pending, tuned, n, tag, tickets = pendings[key]
            pending.phase3_s = time.perf_counter() - t3
            try:
                report = pending.finish()
            except Exception as exc:  # noqa: BLE001 - typed rejection
                for ticket in tickets:
                    self._resolve(ticket, Rejected("error", str(exc),
                                                   ticket.request.app))
                continue
            search_s = time.perf_counter() - t_search
            provenance = "warm" if report.warm_seeds else "cold"
            plan = plan_from_report(report, value_tag_=tag,
                                    provenance=provenance,
                                    timings={"search_s": search_s})
            if self.store:
                self.plans.put(key, plan.payload())
            with self._lock:
                self.stats.searches += 1
                self.stats.search_s.append(search_s)
                self.stats.coalesced += max(len(tickets) - 1, 0)
                if report.warm_seeds:
                    self.stats.warm += len(tickets)
                else:
                    self.stats.cold += len(tickets)
            for ticket in tickets:
                now = time.perf_counter()
                elapsed = now - ticket.submit_t
                timeout_s = ticket.request.timeout_s
                if timeout_s is not None and elapsed > timeout_s:
                    # The plan is cached above regardless — the *next*
                    # ask answers instantly even though this one missed
                    # its budget.
                    self._resolve(ticket, Rejected(
                        "timeout",
                        f"resolved in {elapsed:.3f}s > budget {timeout_s}s",
                        ticket.request.app))
                    continue
                self._resolve(ticket, dataclasses.replace(
                    plan, elapsed_s=elapsed,
                    timings={**plan.timings, "wait_s": t3 - ticket.submit_t}))


def load_trace(path: str | Path) -> list[TuneRequest]:
    """Parse a JSONL request trace (one ``TuneRequest`` field dict per
    line; blank lines and ``#`` comments skipped)."""
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        raw = json.loads(line)
        if "machine_shape" in raw and raw["machine_shape"] is not None:
            raw["machine_shape"] = tuple(int(s) for s in raw["machine_shape"])
        out.append(TuneRequest(**raw))
    return out


def replay(service: MappingService, requests: Sequence[TuneRequest],
           *, timeout: float | None = None
           ) -> list["MappingPlan | Rejected"]:
    """Submit a whole trace, drain (when the service has no workers) and
    collect results in submission order."""
    tickets = [service.submit(r) for r in requests]
    if not service._workers:
        service.drain()
    return [t.result(timeout) for t in tickets]


__all__ = [
    "DEFAULT_COALESCE",
    "DEFAULT_QUEUE_LIMIT",
    "MappingPlan",
    "MappingService",
    "Rejected",
    "RemapRequest",
    "Ticket",
    "TuneRequest",
    "load_trace",
    "plan_from_report",
    "plan_key_for",
    "replay",
    "value_tag",
    "warm_seeds_for",
]
