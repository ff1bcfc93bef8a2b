"""Streaming Phase 3: overlap host candidate expansion with device pricing.

The tuner's Phase 3 has two halves with disjoint resources. Expanding a
beam entry into distribution x order variants — building the mapper IR
program, evaluating ``assignment_grid``, canonicalizing and deduping —
is host/NumPy work; pricing the surviving placements is (under the
``batched-torch`` engine) a series of launches on the card. Run as a
barrier, each half idles while the other works. This module runs them
as a pipeline:

* a **producer thread** walks the expansion generator and feeds finished
  :class:`PriceJob` groups into a bounded queue (the bound is the
  backpressure: the producer can lead the consumer by at most
  ``queue_size`` groups, so peak memory stays flat no matter how fast
  expansion runs);
* the **consumer** (the caller's thread, via :func:`stream_priced`)
  pulls each group, resolves persistent price-cache hits, dispatches the
  misses with ``engine.step_times_async`` — the torch engine returns the
  instant its launches are enqueued — and only blocks on a group's
  ``result()`` once ``in_flight`` newer groups are already queued behind
  it on the device (double buffering). Host expansion of group ``k+1``
  therefore runs concurrently with device pricing of group ``k``.

The pipeline reorders *work*, never arithmetic: each group prices from
its own endpoint arrays into independent buckets, bit-identical to the
barrier path's packed sweep (``tests/test_pipeline.py`` holds the two
paths to ``==`` across the registry). Exceptions on either side cancel
the other and re-raise in the caller; closing the result generator
early unwinds the producer cleanly.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

from repro_torch.sim.batch import price_stacks
from repro_torch.sim.price_cache import PriceCache

#: Producer lead bound (groups buffered between the threads).
DEFAULT_QUEUE_SIZE = 4

#: Dispatched-but-unmaterialized groups the consumer keeps on the device
#: before blocking on the oldest — 2 = classic double buffering.
DEFAULT_IN_FLIGHT = 2

_DONE = object()


@dataclasses.dataclass
class PriceJob:
    """One pricing group: a stack of bijective placements of one
    (grid, options) beam entry, plus per-row payloads and (optionally)
    the persistent-cache coordinates of every row.

    ``entries`` is opaque to the pipeline — the tuner passes its
    ``ScoredCandidate`` objects and writes ``placed_cost`` on yield.
    ``table``/``rows`` are the price-cache digests (table = everything
    but the placement, row = the canonical placement); ``None`` disables
    caching for the job.
    """

    engine: Any
    stack: np.ndarray
    entries: list
    table: bytes | None = None
    rows: Sequence[bytes] | None = None
    cache: PriceCache | None = None

    def split_cached(self) -> tuple[np.ndarray, list[int]]:
        """Look every row up in the persistent cache. Returns
        ``(times, miss_idx)``: ``times`` holds the hit values (misses
        NaN until priced), ``miss_idx`` the row indices that must price
        live. Without a cache every row is a miss."""
        times = np.full(len(self.entries), np.nan, dtype=np.float64)
        if self.cache is None or self.table is None or self.rows is None:
            return times, list(range(len(self.entries)))
        miss_idx = []
        for i, row in enumerate(self.rows):
            value = self.cache.get(self.table, row)
            if value is None:
                miss_idx.append(i)
            else:
                times[i] = value
        return times, miss_idx

    def store(self, miss_idx: Sequence[int], values: np.ndarray) -> None:
        """Persist freshly priced rows (one append per group)."""
        if self.cache is None or self.table is None or self.rows is None:
            return
        self.cache.put_many(
            self.table,
            [(self.rows[i], float(v)) for i, v in zip(miss_idx, values)],
        )


def _merge(job: PriceJob, times: np.ndarray, miss_idx: list[int],
           values: np.ndarray) -> np.ndarray:
    if miss_idx:
        times[np.asarray(miss_idx, dtype=np.intp)] = values
        job.store(miss_idx, values)
    return times


def price_job(job: PriceJob, *, fold: bool = True,
              incremental: bool = True) -> np.ndarray:
    """One group priced synchronously (cache consulted, misses priced,
    results persisted) — the building block the streaming consumer
    defers; also used directly by the tuner's barrier path for groups
    whose engine prices independently."""
    times, miss_idx = job.split_cached()
    if miss_idx:
        values = np.asarray(job.engine.step_times(
            job.stack[np.asarray(miss_idx, dtype=np.intp)],
            fold=fold, incremental=incremental))
    else:
        values = np.empty(0, dtype=np.float64)
    return _merge(job, times, miss_idx, values)


def price_jobs(jobs: Sequence[PriceJob], *, fold: bool = True,
               incremental: bool = True) -> list[np.ndarray]:
    """Price many groups in as few shared congestion passes as possible
    — the tuner's barrier Phase 3, and the tuning service's
    cross-request batching primitive (jobs from *different* requests
    pack into the same :func:`~repro_torch.sim.batch.price_stacks` sweeps, so
    compatible queued requests share device passes).

    Persistent-cache hits are excluded up front and fresh prices are
    written back per group. Each job's ``entries`` get their
    ``placed_cost`` attribute written; the merged per-group times are
    also returned in job order.
    """
    if not jobs:
        return []
    splits = [job.split_cached() for job in jobs]
    priced = price_stacks(
        [(job.engine, job.stack[np.asarray(miss, dtype=np.intp)])
         for job, (_, miss) in zip(jobs, splits)],
        fold=fold, incremental=incremental,
    )
    out = []
    for job, (times, miss), values in zip(jobs, splits, priced):
        times = _merge(job, times, miss, np.asarray(values))
        for entry, t in zip(job.entries, times):
            entry.placed_cost = float(t)
        out.append(times)
    return out


def _produce(jobs: Iterable[PriceJob], out: "queue.Queue",
             stop: threading.Event) -> None:
    """Producer body: drain the expansion generator into the bounded
    queue, forwarding an exception (or exhaustion) as the final item.
    The timeout loop keeps the thread responsive to consumer-side
    cancellation even while the queue is full."""
    try:
        for job in jobs:
            while not stop.is_set():
                try:
                    out.put(job, timeout=0.05)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
        item: Any = _DONE
    except BaseException as exc:  # noqa: BLE001 - re-raised by consumer
        item = exc
    while not stop.is_set():
        try:
            out.put(item, timeout=0.05)
            return
        except queue.Full:
            continue


def stream_priced(jobs: Iterable[PriceJob], *,
                  queue_size: int = DEFAULT_QUEUE_SIZE,
                  in_flight: int = DEFAULT_IN_FLIGHT,
                  fold: bool = True, incremental: bool = True
                  ) -> Iterator[tuple[PriceJob, np.ndarray]]:
    """Yield ``(job, step_times)`` per group, producer/consumer style.

    ``jobs`` (typically the tuner's expansion generator) runs on a
    worker thread; this generator dispatches each arriving group
    asynchronously and yields groups in FIFO order, blocking on a
    group's device result only once ``in_flight`` newer dispatches are
    queued behind it. Values are identical to pricing each job with
    :func:`price_job` — only the waiting overlaps.
    """
    if queue_size < 1:
        raise ValueError(f"queue_size must be >= 1, got {queue_size}")
    if in_flight < 1:
        raise ValueError(f"in_flight must be >= 1, got {in_flight}")
    buf: "queue.Queue" = queue.Queue(maxsize=queue_size)
    stop = threading.Event()
    worker = threading.Thread(
        target=_produce, args=(jobs, buf, stop),
        name="tuner-phase3-producer", daemon=True,
    )
    worker.start()
    pending: list[tuple[PriceJob, Any, np.ndarray, list[int]]] = []

    def materialize(slot) -> tuple[PriceJob, np.ndarray]:
        job, handle, times, miss_idx = slot
        values = (np.asarray(handle.result()) if handle is not None
                  else np.empty(0, dtype=np.float64))
        return job, _merge(job, times, miss_idx, values)

    try:
        while True:
            item = buf.get()
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            job = item
            times, miss_idx = job.split_cached()
            handle = None
            if miss_idx:
                handle = job.engine.step_times_async(
                    job.stack[np.asarray(miss_idx, dtype=np.intp)],
                    fold=fold, incremental=incremental)
            pending.append((job, handle, times, miss_idx))
            if len(pending) > in_flight:
                yield materialize(pending.pop(0))
        for slot in pending:
            yield materialize(slot)
        pending = []
    finally:
        stop.set()
        worker.join(timeout=5.0)


__all__ = [
    "DEFAULT_IN_FLIGHT",
    "DEFAULT_QUEUE_SIZE",
    "PriceJob",
    "price_job",
    "price_jobs",
    "stream_priced",
]
