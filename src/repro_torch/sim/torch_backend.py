"""Device-resident batched pricing: the congestion engine as tensor programs.

:class:`TorchBatchSimulator` is the PyTorch counterpart of
``repro.sim.jax_backend.JaxBatchSimulator``. Where the NumPy engine
(``repro_torch.sim.batch``) gathers ``candidates x phases x ports``
endpoint arrays on the host and prices them through
``Topology.bucket_times``, this engine stages each chunk of a candidate
stack on the card once and prices it there — endpoint gather,
crossing-level stride arithmetic, per-level congestion reduction and the
slab maxima — with no host round trip until ``result()``.

Two formulations, chosen per schedule on the host exactly as the JAX
engine chooses them:

**Dense gather** (``mode="dense"``) — for schedules whose (slab,
endpoint) pairs are unique (each tile sends and receives at most once
per slab: trees, rings, halos, shifted panels — everything the registry
builders emit) and bijective candidate rows. The schedule exports
candidate-independent matrices ``M[slab, tile] -> transfer id``
(sentinel for absent), so a candidate's per-port loads are gathers:
permute columns by the inverse assignment, look up per-level masked
weights, then reduce — per-row segment sums over each level's
``stride`` processors, then the port max. The per-level alpha term folds
into the byte weight exactly: ``msgs*alpha + load/beta ==
sum(nbytes + alpha*beta)/beta``. The tables are materialized per level
and reduced by ``segment_rowmax``: seg 1 at stride-1 levels, seg
``stride`` on the egress and ingress tables of outer levels; with
``use_kernel=True`` (the default) through ``repro_torch.kernels.ops``,
which launches the hand-written kernel on a card, otherwise through its
plain version. A contended machine takes the plain reduction, and its
outer levels reduce their byte and alpha terms separately.

**Segment scatter** (``mode="scatter"``) — the general fallback (repeat
endpoints per slab, non-bijective rows, or a dense table past the cell
ceiling): the ``bucket_times`` formulation as masked ``index_add_``
into compact per-level (direction, slab, port) tables, with masked-out
entries sent to a spill column that is dropped.

``dtype="float64"`` (the default) reproduces the NumPy reference to
~1e-15 relative, inside the registry-wide <=1e-6 parity gate.
``dtype="float32"`` halves the bytes but accumulates port loads in single
precision: ~1e-5 relative drift, fine for ranking, not for the gate.

Launches go to the calling thread's current stream, chunk after chunk;
``step_times_async`` returns once they are enqueued, with a CUDA event
recorded behind the last one, and only ``result()`` waits and copies to
the host. Chunk inputs are staged through pinned memory. No call between
dispatch and ``result()`` synchronizes with the card: the bijectivity
check and the dead-processor refusal stay on the host, in NumPy, before
any launch.

Folding flags are accepted for API parity and ignored: the fold and
incremental shortcuts *copy* dense prices bit for bit by construction,
so always pricing dense returns identical values.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.machine import DegradedMachine, MachineSpec
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.sim.batch import BatchSimulator, ReadyPrices, _count
from repro_torch.sim.collectives import (
    CollectivePattern,
    PackedSchedule,
    packed_schedule,
    register_cache,
)
from repro_torch.sim.topology import Topology

#: Cell ceiling for the dense-gather mode's (n_unique x ntiles) lookup
#: tables; schedules past it (or with repeated per-slab endpoints) use
#: the segment-scatter formulation.
_DENSE_CELLS_MAX = 1 << 25

#: Per-pricing-call device working-set budget (elements); candidate
#: stacks are chunked so ``chunk * cells_per_candidate`` stays under it.
_MAX_DEVICE_ELEMS = 1 << 24

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def platform_info(device: str = "cuda") -> dict:
    """What ``device`` resolves to in this process: its type, the card
    count and names, and whether the dense reduction runs the CUDA kernel
    (only on a card; on the CPU it is the kernel's plain version).
    ``repro_torch.apps.run --backend torch`` prints this so the device
    pricing ran on is never silent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        names = [torch.cuda.get_device_name(i) for i in range(count)]
    else:
        count, names = 1, ["cpu"]
    return {
        "available": count > 0,
        "platform": dev.type,
        "device_count": count,
        "devices": names,
        "kernel": dev.type == "cuda" and count > 0,
    }


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _rows_bijective(a: np.ndarray, nprocs: int) -> bool:
    """True when every stack row is a tile->processor permutation (the
    precondition of the dense-gather mode's inverse-assignment trick)."""
    if a.shape[1] != nprocs or a.size == 0:
        return False
    if int(a.min()) < 0 or int(a.max()) >= nprocs:
        return False
    seen = np.zeros(a.shape, dtype=bool)
    seen[np.arange(a.shape[0])[:, None], a] = True
    return bool(seen.all())


class _ScheduleExport:
    """Device-ready constants of one (PackedSchedule, Topology) pair.

    Host-side numpy arrays (endpoints, slab ids, float64 payloads) plus,
    in dense mode, the candidate-independent ``M[slab, tile] -> transfer
    id`` lookup matrices; their tensors are uploaded once per (device,
    dtype) and kept here. The export itself is cached on the schedule
    object, so its lifetime tracks the memoized schedule's.
    """

    def __init__(self, sched: PackedSchedule, topo: Topology) -> None:
        self.u = sched.n_unique
        self.T = sched.n_transfers
        self.ntiles = int(np.prod(sched.grid))
        self.strides = tuple(int(s) for s in topo.port_strides)
        self.nports = tuple(int(p) for p in topo.spec.level_ports)
        self.alphas = tuple(float(x) for x in topo.alphas)
        self.betas = tuple(float(x) for x in topo.betas)
        self.nprocs = topo.nprocs
        # Per-level port contention factors of the degraded machine, or
        # None when healthy (dead-proc checks stay host-side in
        # ``_dispatch_slabs`` — a masked proc is a refusal, not a price).
        degraded = topo.degraded
        if degraded is not None and degraded.contention is not None:
            self.cont = tuple(
                np.asarray(degraded.port_contention(lvl), dtype=np.float64)
                for lvl in range(len(topo.spec.shape))
            )
        else:
            self.cont = None
        self.src = sched.src.astype(np.int64)
        self.dst = sched.dst.astype(np.int64)
        self.slab = sched.phase_id.astype(np.int64)
        self.nbytes = np.asarray(sched.nbytes, dtype=np.float64)
        # Dense mode needs every (slab, endpoint) pair to be unique. The
        # lookup matrices answer that as they are built: a repeated pair
        # overwrites a cell, leaving fewer than T cells filled (a hashed
        # ``np.unique`` over T keys per direction costs seconds per tune at
        # 4096 procs).
        self.mode = "scatter"
        if self.ntiles == self.nprocs \
                and self.u * self.ntiles <= _DENSE_CELLS_MAX:
            ids = np.arange(self.T, dtype=np.int64)
            self.Ms = np.full((self.u, self.ntiles), self.T, np.int64)
            self.Md = np.full((self.u, self.ntiles), self.T, np.int64)
            self.Ms[self.slab, self.src] = ids
            self.Md[self.slab, self.dst] = ids
            if all(np.count_nonzero(M != self.T) == self.T
                   for M in (self.Ms, self.Md)):
                self.mode = "dense"
            else:
                del self.Ms, self.Md
        if max(2 * self.u * p for p in self.nports) >= 2 ** 31:
            raise ValueError(
                "schedule's congestion table exceeds int32 indexing; "
                "use the NumPy batch engine for this scale"
            )
        self._consts: dict = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ chunking
    def chunk(self, mode: str) -> int:
        if mode == "dense":
            cells = 2 * self.u * self.ntiles
        else:
            cells = sum(2 * self.u * p for p in self.nports) + 4 * self.T
        return _pow2_floor(max(1, _MAX_DEVICE_ELEMS // max(cells, 1)))

    # ----------------------------------------------------- device constants
    def consts(self, device: torch.device, dt: torch.dtype) -> dict:
        """The export's tensors on ``device`` (payloads in ``dt``),
        uploaded at first use and shared by every later chunk."""
        key = (str(device), dt)
        hit = self._consts.get(key)
        if hit is None:
            with self._lock:
                hit = self._consts.get(key)
                if hit is None:
                    def put(x, dtype=None):
                        return torch.tensor(x, dtype=dtype, device=device)

                    hit = {"src": put(self.src), "dst": put(self.dst),
                           "slab": put(self.slab),
                           "nbytes": put(self.nbytes, dt)}
                    if self.mode == "dense":
                        hit["Ms"] = put(self.Ms)
                        hit["Md"] = put(self.Md)
                    if self.cont is not None:
                        hit["cont"] = tuple(put(c, dt) for c in self.cont)
                    self._consts[key] = hit
        return hit

    # ------------------------------------------------------------- pricing
    def price(self, a: torch.Tensor, mode: str, dt: torch.dtype,
              use_kernel: bool) -> torch.Tensor:
        """(n, n_unique) slab times of one chunk ``a`` (n, ntiles) int64
        already on the device, in ``dt``."""
        c = self.consts(a.device, dt)
        if mode == "scatter":
            return self._scatter(a, c, dt)
        # A contended machine takes the plain reduction throughout, as the
        # JAX engine routes it away from its Pallas kernel.
        kernel = use_kernel and self.cont is None
        return self._dense(a, c, dt, kops.segment_rowmax if kernel
                           else kref.segment_rowmax)

    def _level_masks(self, src, dst) -> list[torch.Tensor]:
        """Per-level exactly-crossing masks from stride arithmetic:
        ``src // stride[L] != dst // stride[L]`` first differs at the
        crossing level and stays different inward."""
        masks = []
        outer = torch.zeros(src.shape, dtype=torch.bool, device=src.device)
        for s in self.strides:
            diff = (src // s) != (dst // s)
            masks.append(diff & ~outer)
            outer = outer | diff
        return masks

    @staticmethod
    def _endpoints(a, c):
        return a.index_select(1, c["src"]), a.index_select(1, c["dst"])

    @staticmethod
    def _inverse(a):
        """inv[r, p] = the tile placed on processor p by row r."""
        n, ntiles = a.shape
        tiles = torch.arange(ntiles, device=a.device).expand(n, ntiles)
        return torch.empty_like(a).scatter_(1, a, tiles)

    def _weights(self, w):
        """Append each row's zero sentinel column (the absent transfer id
        ``T`` of the lookup matrices) and flatten for ``torch.take``."""
        zero = torch.zeros((w.shape[0], 1), dtype=w.dtype, device=w.device)
        return torch.cat([w, zero], dim=1).reshape(-1)

    def _lookup(self, flat_w, M, inv=None):
        """Per-candidate (n, u, ntiles) table ``w[r, M[s, inv[r, j]]]`` (or
        ``w[r, M[s, j]]`` without ``inv``), one ``take`` on the flattened
        weights with each row's offset added to its transfer ids."""
        n = flat_w.numel() // (self.T + 1)
        off = (torch.arange(n, device=M.device) * (self.T + 1)).view(n, 1, 1)
        if inv is None:
            idx = M.unsqueeze(0) + off
        else:
            idx = M[:, inv].transpose(0, 1) + off
        return flat_w.take(idx)

    def _dense(self, a, c, dt, reduce):
        """The dense build: each level's per-candidate tables come from
        gathers and ``reduce(table, seg)`` — ``segment_rowmax``, the
        kernel or its plain version — reduces them, seg 1 at stride-1
        levels and seg ``stride`` on the egress and ingress tables of
        outer levels. Each table is dropped before the next is built."""
        n, u = a.shape[0], self.u
        src, dst = self._endpoints(a, c)
        inv = self._inverse(a)
        nb = c["nbytes"]
        out = torch.zeros((n, u), dtype=dt, device=a.device)
        masks = self._level_masks(src, dst)
        for L, (stride, ports, al, be) in enumerate(
                zip(self.strides, self.nports, self.alphas, self.betas)):
            cl = c["cont"][L] if self.cont is not None else None
            if stride == 1:
                # One message per (slab, port, direction): the slab time at
                # this level is a pure max of the per-transfer times; under
                # contention the slower of the transfer's two ports sets
                # its drain.
                if cl is None:
                    t = (al + nb / be).expand(n, -1)
                else:
                    t = al + nb * torch.maximum(cl[src], cl[dst]) / be
                w = self._weights(torch.where(masks[L], t, 0.0))
                tab = self._lookup(w, c["Ms"]).reshape(n * u, self.ntiles)
                out = torch.maximum(out, reduce(tab, 1).reshape(n, u))
                continue
            # Port loads by gather: column-permute M by the inverse
            # assignment, look up masked byte weights (alpha folded in),
            # sum each subtree's `stride` processors, max over ports,
            # both directions.
            for M in (c["Ms"], c["Md"]):
                if cl is None:
                    w = self._weights(torch.where(masks[L], nb + al * be, 0.0))
                    tab = self._lookup(w, M, inv).reshape(n * u, self.ntiles)
                    red = reduce(tab, stride).reshape(n, u)
                else:
                    # Contention scales a port's *byte* drain but not its
                    # per-message alpha, so the folded weight splits: bytes
                    # (scaled per port after the segment sum) + alpha*beta
                    # (unscaled), and no single segment reduce applies.
                    wb = self._weights(torch.where(masks[L], nb, 0.0))
                    wa = self._weights(torch.where(
                        masks[L], torch.full_like(nb, al * be), 0.0))
                    load = (self._lookup(wb, M, inv)
                            .reshape(n, u, ports, stride).sum(3) * cl
                            + self._lookup(wa, M, inv)
                            .reshape(n, u, ports, stride).sum(3))
                    red = load.amax(2)
                out = torch.maximum(out, red / be)
        return out

    def _scatter(self, a, c, dt):
        """The general formulation: masked segment-sum scatter-adds into
        per-level (direction, slab, port) tables. Masked-out transfers go
        to a spill cell past each row's table, which is dropped. Handles
        repeated per-slab endpoints (alltoall) and non-bijective
        placements."""
        n, u = a.shape[0], self.u
        src, dst = self._endpoints(a, c)
        slab = c["slab"]
        nb = c["nbytes"]
        out = torch.zeros((n, u), dtype=dt, device=a.device)
        masks = self._level_masks(src, dst)
        for L, (stride, ports, al, be) in enumerate(
                zip(self.strides, self.nports, self.alphas, self.betas)):
            width = 2 * u * ports
            spill = width                  # one extra cell per row
            base = slab * ports
            cell = torch.cat([
                torch.where(masks[L], base + src // stride, spill),
                torch.where(masks[L], width // 2 + base + dst // stride,
                            spill),
            ], dim=1)
            if self.cont is None:
                w = torch.where(masks[L], nb + al * be, 0.0)
                ws = torch.cat([w, w], dim=1)
            else:
                # Scale each transfer's byte load by its port's contention
                # factor per direction; alpha unscaled.
                cl = c["cont"][L]
                ws = torch.cat([
                    torch.where(masks[L], nb * cl[src // stride] + al * be,
                                0.0),
                    torch.where(masks[L], nb * cl[dst // stride] + al * be,
                                0.0),
                ], dim=1)
            rows = torch.arange(n, device=a.device).view(n, 1) * (width + 1)
            tab = torch.zeros(n * (width + 1), dtype=dt, device=a.device)
            tab.index_add_(0, (cell + rows).reshape(-1), ws.reshape(-1))
            tab = tab.view(n, width + 1)[:, :width] / be
            out = torch.maximum(out, tab.view(n, 2, u, ports).amax(dim=(1, 3)))
        return out


#: Live schedules carrying a ``_torch_exports`` cache, held weakly (by
#: ``id`` — PackedSchedule's ndarray fields make it unhashable, ruling
#: out a WeakSet; dead ids are pruned automatically and a recycled id
#: simply overwrites) plus hit/miss counters, so ``repro_torch.sim
#: .collectives.cache_stats()`` can report the export population and
#: ``clear_caches()`` can reclaim it (device tensors included).
_EXPORT_HOSTS: "weakref.WeakValueDictionary[int, PackedSchedule]" = \
    weakref.WeakValueDictionary()
_EXPORT_STATS = {"hits": 0, "misses": 0}


def _exports_clear() -> None:
    for sched in list(_EXPORT_HOSTS.values()):
        cache = getattr(sched, "_torch_exports", None)
        if cache:
            cache.clear()
    for key in _EXPORT_STATS:
        _EXPORT_STATS[key] = 0


def _exports_stats() -> dict:
    size = sum(len(getattr(sched, "_torch_exports", ()) or ())
               for sched in _EXPORT_HOSTS.values())
    return {"size": size, **_EXPORT_STATS}


register_cache("torch_exports", _exports_clear, _exports_stats)


def _export_for(sched: PackedSchedule, topo: Topology) -> _ScheduleExport:
    """The (schedule, topology) export, cached on the schedule object so
    its device constants are shared by every engine pricing that
    schedule and die with it."""
    cache = getattr(sched, "_torch_exports", None)
    if cache is None:
        cache = {}
        object.__setattr__(sched, "_torch_exports", cache)
        _EXPORT_HOSTS[id(sched)] = sched
    key = (topo.spec, topo.alphas, topo.betas, topo.degraded)
    hit = cache.get(key)
    if hit is None:
        _EXPORT_STATS["misses"] += 1
        hit = cache[key] = _ScheduleExport(sched, topo)
    else:
        _EXPORT_STATS["hits"] += 1
    return hit


@dataclasses.dataclass(frozen=True)
class TorchBatchSimulator(BatchSimulator):
    """The batched engine with device-resident congestion pricing.

    Same contract as :class:`BatchSimulator` (stacks of tile->processor
    placements in, steady-state seconds out; ``fold``/``incremental``
    accepted but moot — see the module docstring); ``price_stacks``
    detects ``prices_independently`` and lets each stack run as its own
    launches instead of joining the host gather pass.
    """

    dtype: str = "float64"
    device: str = "cuda"
    use_kernel: bool = True

    #: Each stack prices as its own launches on the card; do not
    #: concatenate into the NumPy congestion pass (checked by
    #: ``price_stacks``).
    prices_independently = True

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"dtype must be one of {tuple(_DTYPES)}, got {self.dtype!r}"
            )
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the 'batched-torch' engine was asked to price on "
                f"{self.device!r}, and torch finds no CUDA card here; pass "
                "device='cpu' to price on the CPU"
            )
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device!r}")

    def phase_durations(self, assignments: np.ndarray, *,
                        fold: bool = True,
                        incremental: bool = True) -> np.ndarray:
        """(N, n_phases) congestion-priced phase times, the whole stack
        as chunked launches. ``fold`` and ``incremental`` are accepted
        for interface parity and ignored: both shortcuts copy dense
        prices bit-exactly, so dense pricing returns the same values
        either way."""
        del fold, incremental
        a = self._flat_assignments(assignments)
        n, sched = a.shape[0], self.schedule
        if sched.n_transfers == 0 or n == 0 or sched.n_phases == 0:
            return np.zeros((n, sched.n_phases), dtype=np.float64)
        slab_times = _InFlightPrices(self, *self._dispatch_slabs(a)).slabs()
        _count("pairs_priced",
               n * int((np.diff(sched.starts) > 0).sum()))
        return slab_times[:, sched.phase_map]

    def _dispatch_slabs(self, a: np.ndarray
                        ) -> tuple[torch.Tensor, "torch.cuda.Event | None"]:
        """Launch the stack's chunked pricing on the calling thread's
        current stream and return the (N, n_unique) device output plus
        the event recorded behind the last launch, without waiting.

        Each chunk's assignments go to the card through pinned memory
        (``non_blocking``), so the host is free to expand the next
        candidate group while the card prices this one."""
        exp = _export_for(self.schedule, self.topology)
        degraded = self.topology.degraded
        if degraded is not None and degraded.dead_procs:
            # Masked procs are unplaceable: refuse on the host before any
            # launch (same contract as Topology.bucket_times).
            self.topology.check_placeable(a)
        mode = exp.mode
        if mode == "dense" and not _rows_bijective(a, exp.nprocs):
            mode = "scatter"      # dense needs invertible rows
        n = a.shape[0]
        chunk = exp.chunk(mode)
        dev = torch.device(self.device)
        dt = _DTYPES[self.dtype]
        on_card = dev.type == "cuda"
        host = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
        out = torch.empty((n, exp.u), dtype=dt, device=dev)
        for lo in range(0, n, chunk):
            blk = host[lo:lo + chunk]
            if on_card:
                blk = blk.pin_memory().to(dev, non_blocking=True)
            out[lo:lo + chunk] = exp.price(blk, mode, dt, self.use_kernel)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return out, event

    def step_times_async(self, assignments: np.ndarray, *,
                         fold: bool = True,
                         incremental: bool = True) -> "ReadyPrices":
        """Launch the whole stack's pricing and return immediately with a
        deferred handle; ``result()`` waits for the card and closes the
        step recurrence. Between dispatch and ``result()`` the host is
        free — this is the overlap the tuner's streaming pipeline lives
        on. Values are bit-identical to :meth:`step_times` (same
        launches, same chunking; only the wait moves)."""
        del fold, incremental     # moot — see phase_durations
        a = self._flat_assignments(assignments)
        n, sched = a.shape[0], self.schedule
        if sched.n_transfers == 0 or n == 0 or sched.n_phases == 0:
            return ReadyPrices(self._close_steps(
                np.zeros((n, sched.n_phases), dtype=np.float64)))
        handle = _InFlightPrices(self, *self._dispatch_slabs(a))
        _count("pairs_priced",
               n * int((np.diff(sched.starts) > 0).sum()))
        return handle


class _InFlightPrices:
    """Deferred step times of one dispatched stack: the launches are
    already queued on the card; ``result()`` waits on the recorded event
    (from whichever thread calls it), copies the slab times to the host,
    and closes the step recurrence. Idempotent — the device output is
    dropped after the first materialization."""

    __slots__ = ("_sim", "_out", "_event", "_value")

    def __init__(self, sim: TorchBatchSimulator, out: torch.Tensor,
                 event: "torch.cuda.Event | None") -> None:
        self._sim = sim
        self._out = out
        self._event = event
        self._value: np.ndarray | None = None

    def slabs(self) -> np.ndarray:
        """(N, n_unique) float64 slab times on the host."""
        if self._event is not None:
            self._event.synchronize()
        slabs = self._out.to("cpu", torch.float64).numpy()
        self._out = self._event = None
        return slabs

    def result(self) -> np.ndarray:
        if self._value is None:
            sim = self._sim
            slab_times = self.slabs()
            self._value = sim._close_steps(
                slab_times[:, sim.schedule.phase_map])
        return self._value


def to_torch(engine: BatchSimulator, *, dtype: str = "float64",
             device: str = "cuda", use_kernel: bool = True
             ) -> TorchBatchSimulator:
    """The torch twin of a NumPy batch engine (same schedule/topology/step
    closure, device-resident pricing)."""
    return TorchBatchSimulator(
        topology=engine.topology, schedule=engine.schedule,
        compute_s=engine.compute_s, backpressure=engine.backpressure,
        steps=engine.steps, dtype=dtype, device=device,
        use_kernel=use_kernel,
    )


def torch_batch_simulator(pattern: CollectivePattern, spec: MachineSpec,
                          grid: Sequence[int], *, step_flops: float,
                          elem_bytes: int = 4, backpressure: int = 2,
                          steps: int = 3,
                          alphas: tuple[float, ...] | None = None,
                          dtype: str = "float64", device: str = "cuda",
                          use_kernel: bool = True,
                          degraded: "DegradedMachine | None" = None
                          ) -> TorchBatchSimulator:
    """Build the torch engine for one (pattern, machine, grid) point —
    the device-resident counterpart of ``batch_simulator``."""
    grid = tuple(int(g) for g in grid)
    return TorchBatchSimulator(
        topology=Topology.from_spec(spec, alphas=alphas, degraded=degraded),
        schedule=packed_schedule(pattern, grid, elem_bytes=elem_bytes),
        compute_s=float(step_flops) / (spec.nprocs * spec.peak_flops),
        backpressure=backpressure,
        steps=steps,
        dtype=dtype,
        device=device,
        use_kernel=use_kernel,
    )


__all__ = [
    "TorchBatchSimulator",
    "platform_info",
    "to_torch",
    "torch_batch_simulator",
]
