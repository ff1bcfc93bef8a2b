"""Hierarchical alpha-beta network model built from a :class:`MachineSpec`.

The machine is a level tree: ``spec.shape = (nodes, gpus)`` means every
node is a switch whose children are GPUs, and the nodes hang off one root
fabric. A point-to-point message between processors ``src`` and ``dst``
routes up the tree to their lowest common ancestor and back down; the
*crossing level* — the outermost coordinate where the two processors
differ — determines which fabric the message pays for:

  * latency ``alpha[level]`` per message, and
  * bandwidth ``beta[level]`` (= ``spec.link_bw(level)``) per *port*.

Ports model contention on shared links. A message crossing level ``L``
leaves through the port of the level-``(L+1)`` subtree containing ``src``
(for a two-level machine and ``L = 0`` that is the source *node's* NIC,
shared by every GPU in the node) and enters through the subtree port
containing ``dst``. Messages in flight at the same time through the same
port share its bandwidth, so the time of a set of concurrent transfers is
the max over ports of ``n_msgs * alpha + port_bytes / beta`` — the
standard congestion (max-load) alpha-beta cost used by static mapping
cost models.

The hot path is fully array-programmed: crossing levels are pure
stride arithmetic on flat processor ids (``src // stride[L] != dst //
stride[L]`` — no precomputed all-pairs table, so there is no processor
ceiling), and congestion pricing is a single bincount /
``np.add.reduceat`` pass over an arbitrary *bucket* axis — one bucket
per phase for the event engine, ``candidates x phases`` buckets for the
batched engine (``repro_torch.sim.batch``) — so thousands of phases across a
whole tuner beam are priced in one call, at 1024 or 131072 processors
alike.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.machine import DegradedMachine, MachineSpec

#: Default per-message latencies by level depth, outermost first. The
#: outermost fabric (DCI / inter-node Ethernet) is ~an order of magnitude
#: slower to enter than the intra-node links. Both are scaled to the
#: repo's scaled-down problem sizes (the registry's canonical workloads
#: move KB..MB faces, not the GB payloads of the paper's full runs) so
#: the per-message setup term does not drown the byte costs the volume
#: models price; pass explicit ``alphas`` to ``Topology.from_spec`` for
#: full-scale latency studies.
DEFAULT_ALPHA_OUTER = 2e-7      # seconds, inter-node message setup
DEFAULT_ALPHA_INNER = 5e-8      # seconds, intra-node / on-fabric setup

#: Dense-bincount ceiling for congestion pricing: when
#: ``n_buckets * n_ports`` exceeds this, the sparse sorted-key
#: ``np.add.reduceat`` path is used instead (same float results —
#: both sum each port's bytes in transfer order).
_DENSE_PORT_CELLS = 1 << 23


@dataclasses.dataclass(frozen=True)
class Topology:
    """The level tree with per-level (alpha, beta) parameters.

    ``alphas``/``betas`` are outermost-first, one entry per level of
    ``spec.shape``; ``betas`` defaults to ``spec.level_bws``.

    ``degraded`` carries the machine's fault state
    (:class:`~repro_torch.core.machine.DegradedMachine`): transfers touching a
    dead processor are refused (``ValueError`` — a masked proc is
    unplaceable, not slow), and a port with contention factor ``c`` drains
    bytes ``c`` times slower (alpha is unaffected). A trivial degradation
    is normalized to ``None`` by :meth:`from_spec`, so a healthy-equivalent
    ``DegradedMachine`` prices bit-identically to the healthy topology.
    """

    spec: MachineSpec
    alphas: tuple[float, ...]
    betas: tuple[float, ...]
    degraded: DegradedMachine | None = None

    @classmethod
    def from_spec(cls, spec: MachineSpec,
                  alphas: tuple[float, ...] | None = None,
                  degraded: DegradedMachine | None = None) -> "Topology":
        k = len(spec.shape)
        if alphas is None:
            alphas = ((DEFAULT_ALPHA_OUTER,) + (DEFAULT_ALPHA_INNER,) * (k - 1)
                      if k > 1 else (DEFAULT_ALPHA_INNER,))
        if len(alphas) != k:
            raise ValueError(
                f"alphas needs one latency per level: got {len(alphas)} "
                f"for {k} levels"
            )
        if degraded is not None:
            if degraded.spec != spec:
                raise ValueError(
                    "degraded view describes a different machine than spec"
                )
            if degraded.is_trivial:
                degraded = None       # healthy-equivalent: keep bit-identity
        return cls(spec=spec, alphas=tuple(alphas), betas=spec.level_bws,
                   degraded=degraded)

    # ------------------------------------------------------- degraded state
    def _dead_array(self) -> np.ndarray:
        """Dead processor ids as an int64 array (cached; empty if healthy)."""
        arr = getattr(self, "_dead_cache", None)
        if arr is None:
            dead = self.degraded.dead_procs if self.degraded else ()
            arr = np.asarray(dead, dtype=np.int64)
            object.__setattr__(self, "_dead_cache", arr)
        return arr

    def _contention_flat(self) -> "tuple[np.ndarray, np.ndarray] | None":
        """Per-port contention factors flattened across levels: returns
        ``(flat, offsets)`` with ``flat[offsets[L] + port]`` the level-L
        factor, or ``None`` when no port is contended (cached)."""
        cached = getattr(self, "_cont_cache", "unset")
        if cached == "unset":
            if self.degraded is None or self.degraded.contention is None:
                cached = None
            else:
                rows = [np.asarray(self.degraded.port_contention(lvl),
                                   dtype=np.float64)
                        for lvl in range(len(self.spec.shape))]
                offsets = np.r_[
                    0, np.cumsum([r.size for r in rows])
                ].astype(np.int64)
                cached = (np.concatenate(rows), offsets)
            object.__setattr__(self, "_cont_cache", cached)
        return cached

    def check_placeable(self, procs: np.ndarray) -> None:
        """Raise ``ValueError`` if any processor in ``procs`` is dead."""
        dead = self._dead_array()
        if dead.size == 0:
            return
        procs = np.asarray(procs, dtype=np.int64).reshape(-1)
        bad = np.isin(procs, dead)
        if bad.any():
            hit = sorted(set(procs[bad].tolist()))[:8]
            raise ValueError(
                f"placement touches dead processor(s) {hit}: masked procs "
                f"are unplaceable on this degraded machine"
            )

    # -------------------------------------------------------------- routing
    @property
    def nprocs(self) -> int:
        return self.spec.nprocs

    @property
    def port_strides(self) -> tuple[int, ...]:
        """Flat-id divisor per level: ``proc // stride[L]`` is the flat
        index of the level-(L+1) subtree (= port id) containing ``proc``."""
        return self.spec.level_strides

    def coords(self, procs: np.ndarray) -> np.ndarray:
        """(n, k) level coordinates of flat processor ids (row-major)."""
        procs = np.asarray(procs, dtype=np.int64)
        return np.stack(
            np.unravel_index(procs, self.spec.shape), axis=-1
        ).reshape(procs.shape + (len(self.spec.shape),))

    def crossing_levels(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Outermost level where src and dst coordinates differ (the fabric
        the message crosses); ``k`` (= number of levels) for src == dst,
        i.e. a local copy that never touches the network.

        Pure stride arithmetic — ``src // stride[L]`` is the flat index
        of the level-(L+1) subtree, and subtree indices differ exactly
        from the outermost differing coordinate inward, so sweeping the
        levels innermost-first and overwriting leaves the outermost
        match. O(k) vectorized ops per call, no precomputed table and no
        processor-count ceiling.
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        k = len(self.spec.shape)
        out = np.full(np.broadcast_shapes(src.shape, dst.shape), k,
                      dtype=np.int64)
        for lvl in range(k - 1, -1, -1):
            s = self.spec.level_strides[lvl]
            np.copyto(out, lvl, where=(src // s) != (dst // s))
        return out

    def transfer_time(self, nbytes: float, level: int) -> float:
        """Uncontended point-to-point time for one message at one level."""
        return self.alphas[level] + float(nbytes) / self.betas[level]

    # ----------------------------------------------------------- congestion
    def bucket_times(self, src: np.ndarray, dst: np.ndarray,
                     nbytes: np.ndarray, bucket: np.ndarray,
                     n_buckets: int) -> np.ndarray:
        """Congestion-priced completion time of ``n_buckets`` independent
        transfer sets in one vectorized pass.

        ``bucket`` maps each transfer to its set (a phase for the event
        engine; ``candidate * n_phases + phase`` for the batched engine).
        Within each bucket the transfers run concurrently: every level-L
        crossing loads the egress port of its source subtree and the
        ingress port of its destination subtree (full duplex), and the
        bucket completes when its most-loaded port drains::

            time[b] = max over ports ( msgs * alpha[L] + bytes / beta[L] )

        Port loads are accumulated with ``np.bincount`` (or, past the
        dense ceiling, a sorted-key ``np.add.reduceat`` segment pass);
        both sum each port's bytes in transfer order, so the result is
        bit-identical to the legacy per-transfer accumulation.
        """
        src = np.asarray(src, dtype=np.int64)
        nbytes = np.broadcast_to(
            np.asarray(nbytes, dtype=np.float64), src.shape
        ).reshape(-1)
        src = src.reshape(-1)
        dst = np.asarray(dst, dtype=np.int64).reshape(-1)
        bucket = np.asarray(bucket, dtype=np.int64).reshape(-1)
        n_buckets = int(n_buckets)
        out = np.zeros(n_buckets, dtype=np.float64)
        if src.size == 0:
            return out
        if self.degraded is not None and self.degraded.dead_procs:
            self.check_placeable(src)
            self.check_placeable(dst)
        k = len(self.spec.shape)
        levels = self.crossing_levels(src, dst).astype(np.int64)
        valid = levels < k               # local copies never hit the fabric
        if not valid.all():
            levels, bucket = levels[valid], bucket[valid]
            src, dst, nbytes = src[valid], dst[valid], nbytes[valid]
        if src.size == 0:
            return out
        # One unified (level, direction, bucket, port) key per port load:
        # the whole pass — every level, both full-duplex directions, all
        # buckets — is two bincounts (or one sorted reduceat sweep). Each
        # level contributes only its true port count (level 0 of a
        # (nodes, gpus) machine has `nodes` NICs, not `nprocs`).
        strides = np.asarray(self.port_strides, dtype=np.int64)
        nports = np.asarray(self.spec.level_ports, dtype=np.int64)
        per_lvl = 2 * n_buckets * nports
        offsets = np.r_[0, np.cumsum(per_lvl)]
        cells = int(offsets[-1])
        t_np = nports[levels]
        base = offsets[levels] + bucket * t_np
        dir_off = n_buckets * t_np
        eg_port = src // strides[levels]
        in_port = dst // strides[levels]
        key = np.concatenate([base + eg_port, base + dir_off + in_port])
        cont = self._contention_flat()
        if cont is None:
            w = np.concatenate([nbytes, nbytes])
        else:
            # A contended port drains bytes `c` times slower: scale each
            # transfer's byte load by its port's factor before summing.
            # Alpha (message setup) is unaffected, so the msgs counts below
            # stay untouched.
            flat, cont_off = cont
            w = np.concatenate([
                nbytes * flat[cont_off[levels] + eg_port],
                nbytes * flat[cont_off[levels] + in_port],
            ])
        # Dense bincount when the port table is reasonably filled; the
        # sorted sparse sweep when transfers are much sparser than the
        # table (zeroing/scanning empty cells would dominate).
        if cells <= _DENSE_PORT_CELLS and cells <= max(4096, 8 * key.size):
            load = np.bincount(key, weights=w, minlength=cells)
            msgs = np.bincount(key, minlength=cells)
            for lvl in range(k):
                sl = slice(offsets[lvl], offsets[lvl + 1])
                t = (msgs[sl] * self.alphas[lvl]
                     + load[sl] / self.betas[lvl])
                np.maximum(
                    out,
                    t.reshape(2, n_buckets, nports[lvl]).max(axis=(0, 2)),
                    out=out,
                )
            return out
        # Sparse path: stable sort keeps equal keys in transfer order.
        # reduceat's pairwise float summation can differ from bincount's
        # sequential accumulation by rounding ulps — far inside the 1e-9
        # engine-agreement contract benchmarks/sim_eval.py enforces.
        order = np.argsort(key, kind="stable")
        sk, sw = key[order], w[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sk)) + 1]
        load = np.add.reduceat(sw, starts)
        msgs = np.diff(np.r_[starts, sk.size])
        cell = sk[starts]
        lvl = np.searchsorted(offsets, cell, side="right") - 1
        t = (msgs * np.asarray(self.alphas)[lvl]
             + load / np.asarray(self.betas)[lvl])
        # Fold per-port times to per-(level, direction, bucket) maxima
        # (contiguous runs of the sorted keys), then into the buckets.
        c_np = nports[lvl]
        group_bucket = (cell - offsets[lvl]) % (n_buckets * c_np) // c_np
        group = (cell - offsets[lvl]) // c_np + 2 * n_buckets * lvl
        g_starts = np.r_[0, np.flatnonzero(np.diff(group)) + 1]
        g_max = np.maximum.reduceat(t, g_starts)
        np.maximum.at(out, group_bucket[g_starts], g_max)
        return out

    def phase_time(self, src: np.ndarray, dst: np.ndarray,
                   nbytes: np.ndarray) -> float:
        """Time for one set of concurrent transfers under port contention.

        For each level ``L``, the transfers crossing at ``L`` load the
        egress port of the subtree ``src[:L+1]`` and the ingress port of
        ``dst[:L+1]``; the phase completes when the most-loaded port
        drains: ``max over ports (msgs * alpha[L] + bytes / beta[L])``.
        Same-processor transfers are free (no network crossing).
        """
        src = np.asarray(src, dtype=np.int64).reshape(-1)
        bucket = np.zeros(src.shape, dtype=np.int64)
        return float(self.bucket_times(src, dst, nbytes, bucket, 1)[0])

    def phase_times(self, phases: Sequence) -> np.ndarray:
        """Congestion-priced durations of a whole phase list in one pass
        (one bucket per phase). Equivalent to ``[phase_time(ph.src,
        ph.dst, ph.nbytes) for ph in phases]`` but without the per-phase
        Python loop — the event engine's schedule pricing."""
        n = len(phases)
        if n == 0:
            return np.zeros(0, dtype=np.float64)
        sizes = [ph.src.size for ph in phases]
        if not any(sizes):
            return np.zeros(n, dtype=np.float64)
        src = np.concatenate([ph.src for ph in phases])
        dst = np.concatenate([ph.dst for ph in phases])
        nbytes = np.concatenate([
            np.broadcast_to(np.asarray(ph.nbytes, np.float64), ph.src.shape)
            for ph in phases
        ])
        bucket = np.repeat(np.arange(n, dtype=np.int64), sizes)
        return self.bucket_times(src, dst, nbytes, bucket, n)


__all__ = [
    "DEFAULT_ALPHA_INNER",
    "DEFAULT_ALPHA_OUTER",
    "Topology",
]
