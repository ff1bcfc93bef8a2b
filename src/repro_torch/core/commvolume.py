"""Communication-volume models (paper Sec. 4.2, Sec. 7.2 + framework models).

These are the analytic objectives that ``decompose`` minimizes, plus the
per-application volumes used by the benchmark harnesses to reproduce the
paper's performance deltas as communication ratios, and the LM-parallelism
cost model used by the beyond-paper auto-sharder.

Every model is also packaged behind the :class:`CostModel` protocol — a
callable from a candidate factor tuple to a scalar volume — so halo,
transpose, the six matmul costs and the LM step model are interchangeable
objectives: ``decompose.optimal_factorization(objective=...)``, the mapper
autotuner (``repro.search``) and the auto-sharder all consume the same
objects.

All volumes are in *elements* unless a dtype size is applied by the caller.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


def _prod(xs: Sequence[float]) -> float:
    return math.prod(xs) if xs else 1.0


# ------------------------------------------------------------- paper Sec. 4.2
def hyperrect_surface(extents: Sequence[float]) -> float:
    """SA(x_1..x_k) = 2 * prod(x) * sum(1/x)  (paper Sec. 4.2)."""
    p = _prod(extents)
    return 2.0 * p * sum(1.0 / x for x in extents)


def halo_surface_volume(lengths: Sequence[int], factors: Sequence[int]) -> float:
    """Exact interior-surface volume of Sec. 4.2:

        2*S = SA(w_1..w_k) * d  -  SA(l_1..l_k),   w_m = l_m / d_m.

    Returns S (elements crossing interior processor boundaries, counted once).
    """
    w = [l / f for l, f in zip(lengths, factors)]
    d = _prod(factors)
    return 0.5 * (hyperrect_surface(w) * d - hyperrect_surface(lengths))


def aniso_halo_volume(
    lengths: Sequence[int], factors: Sequence[int], halo: Sequence[float]
) -> float:
    """Sec. 7.2.1: V = sum_n d_n * h_n * prod_{m != n} l_m."""
    k = len(lengths)
    total = 0.0
    for n in range(k):
        rest = _prod([lengths[m] for m in range(k) if m != n])
        total += factors[n] * halo[n] * rest
    return total


def transpose_volume(
    lengths: Sequence[int], factors: Sequence[int], transpose_dims: Sequence[int]
) -> float:
    """Sec. 7.2.2: total all-to-all volume for transposes along given dims.

    V*_n = (1 - 1/d_n) * prod(w) * d  with prod(w)*d = prod(l).
    """
    lprod = _prod(lengths)
    return sum((1.0 - 1.0 / factors[n]) * lprod for n in transpose_dims)


# --------------------------------------------------- matmul algorithm volumes
# Per-algorithm total communication volume (elements moved between
# processors) for C[m,n] += A[m,k] @ B[k,n]. These are the standard
# published costs; used by benchmarks/mapper_tuning.py and
# benchmarks/heuristic_gap.py to reproduce the paper's Fig. 13/Table 2
# effects analytically, and validated at small scale by the shard_map
# implementations in src/repro/matmul/.


@dataclasses.dataclass(frozen=True)
class MatmulProblem:
    m: int
    n: int
    k: int

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k


def cannon_volume(p: MatmulProblem, grid: tuple[int, int]) -> float:
    """Cannon's on a (q, q) torus: q shift rounds of A and B tiles."""
    q1, q2 = grid
    if q1 != q2:
        raise ValueError("Cannon's algorithm requires a square grid")
    q = q1
    tile_a = (p.m / q) * (p.k / q)
    tile_b = (p.k / q) * (p.n / q)
    # Initial skew (<= q/2 hops each) + q-1 shift rounds, every processor.
    rounds = q - 1
    return q * q * rounds * (tile_a + tile_b)


def summa_volume(p: MatmulProblem, grid: tuple[int, int], panel: int = 1) -> float:
    """SUMMA on (pr, pc): row/col broadcasts of panels over k steps."""
    pr, pc = grid
    # Every processor receives A panels (m/pr * k) from its row and
    # B panels (k * n/pc) from its column over the full k dimension.
    recv_per_proc = (p.m / pr) * p.k + p.k * (p.n / pc)
    # Subtract locally-owned panels.
    local = (p.m / pr) * (p.k / pc) + (p.k / pr) * (p.n / pc)
    return pr * pc * max(recv_per_proc - local, 0.0)


def pumma_volume(p: MatmulProblem, grid: tuple[int, int]) -> float:
    """PUMMA has SUMMA-like asymptotic volume (block-cyclic panels)."""
    return summa_volume(p, grid)


def johnson_volume(p: MatmulProblem, grid: tuple[int, int, int]) -> float:
    """Johnson's 3D algorithm on (q, q, q): one broadcast of A and B tiles
    along the third dim + one reduction of C partials."""
    q1, q2, q3 = grid
    tile_a = (p.m / q1) * (p.k / q3)
    tile_b = (p.k / q3) * (p.n / q2)
    tile_c = (p.m / q1) * (p.n / q2)
    nproc = q1 * q2 * q3
    return nproc * (tile_a + tile_b + tile_c)


def solomonik_volume(p: MatmulProblem, grid: tuple[int, int, int]) -> float:
    """Solomonik 2.5D on (q, q, c): c-fold replication; shifts shrink by c."""
    q1, q2, c = grid
    if q1 != q2:
        raise ValueError("Solomonik's 2.5D algorithm requires a (q, q, c) grid")
    if c < 1:
        raise ValueError(f"replication factor must be >= 1, got {c}")
    q = q1
    tile_a = (p.m / q) * (p.k / q)
    tile_b = (p.k / q) * (p.n / q)
    rounds = max(q // c - 1, 0)
    shift = q * q * c * rounds * (tile_a + tile_b)
    # Broadcast of initial replicas + final C reduction over the c axis.
    repl = (c - 1) * (p.m * p.k + p.k * p.n)
    reduce_c = (c - 1) * p.m * p.n
    return shift + repl + reduce_c


def cosma_volume(p: MatmulProblem, nproc: int) -> float:
    """COSMA's near-optimal volume: ~ 2 * m*n*k / sqrt(S_opt) with the
    red-blue pebbling bound; we report the grid-derived volume for the
    grid COSMA's heuristic picks (greedy divide of the largest dim)."""
    g = cosma_grid(p, nproc)
    return johnson_volume(p, g)


def cosma_grid(p: MatmulProblem, nproc: int) -> tuple[int, int, int]:
    """COSMA-style grid: repeatedly assign prime factors to the dimension
    with the largest per-processor extent (communication-avoiding split)."""
    from repro_torch.core.decompose import prime_factorization

    dims = [float(p.m), float(p.n), float(p.k)]
    grid = [1, 1, 1]
    for f in sorted(prime_factorization(nproc), reverse=True):
        j = max(range(3), key=lambda i: dims[i] / grid[i])
        grid[j] *= f
    return tuple(grid)  # type: ignore[return-value]


# ----------------------------------------------------- LM parallelism volumes
@dataclasses.dataclass(frozen=True)
class LMCommModel:
    """Per-training-step communication volume (bytes) of an LM step under a
    (dp, tp, ep, pp) factorization. Used by the auto-sharder's decompose
    objective (the beyond-paper integration of the paper's Sec. 7.2 insight:
    only the objective changes, the enumerator is reused).
    """

    param_bytes: float          # total parameter bytes (dense path)
    act_bytes_per_layer: float  # batch*seq*d_model*dtype on one replica
    n_layers: int
    moe_param_bytes: float = 0.0   # routed-expert parameter bytes
    moe_tokens_bytes: float = 0.0  # per-layer dispatched token bytes (EP a2a)
    n_moe_layers: int = 0

    def step_volume(self, dp: int, tp: int, ep: int = 1) -> float:
        """Total inter-chip bytes moved per optimization step (ring costs)."""
        vol = 0.0
        # DP gradient all-reduce: ring 2*(dp-1)/dp over the dp-sharded grads.
        if dp > 1:
            vol += 2.0 * (dp - 1) / dp * self.param_bytes
        # TP: per layer, fwd+bwd each do ~2 all-reduces (Megatron) of the
        # activation shard: 4 * 2*(tp-1)/tp * act/dp per layer.
        if tp > 1:
            per_layer = 4.0 * 2.0 * (tp - 1) / tp * (self.act_bytes_per_layer / dp)
            vol += per_layer * self.n_layers
        # EP all-to-all: dispatch + combine, fwd + bwd = 4 movements of the
        # routed token bytes, scaled by the fraction leaving the shard.
        if ep > 1 and self.n_moe_layers:
            per_layer = 4.0 * (1.0 - 1.0 / ep) * (self.moe_tokens_bytes / dp)
            vol += per_layer * self.n_moe_layers
        return vol


# --------------------------------------------------------- CostModel protocol
class CostModel:
    """An interchangeable communication objective over candidate factor tuples.

    ``cost(factors)`` maps one ordered factor tuple — a processor grid for
    the application models, a ``(dp, tp[, ep])`` parallelism split for the
    LM model — to a modeled communication volume. Instances are callables,
    so a CostModel drops unchanged into
    ``decompose.optimal_factorization(objective=...)`` and
    ``ProcSpace.decompose(objective=...)``; the mapper autotuner
    (``repro.search``) and the auto-sharder score candidates through the
    same interface.

    Implementations raise ``ValueError`` for factor tuples the model cannot
    use (wrong arity, Cannon's square-grid requirement, ...); enumerative
    consumers catch it and skip the candidate.

    The protocol is unit-agnostic: the models in this module return
    communication volumes (elements or bytes), while
    ``repro.sim.cost.SimulatedTimeCostModel`` returns predicted *seconds*
    from the discrete-event simulator — the same consumers rank either.
    """

    name: str = "cost"

    def cost(self, factors: Sequence[int]) -> float:
        raise NotImplementedError

    def __call__(self, factors: Sequence[int]) -> float:
        return self.cost(factors)


@dataclasses.dataclass(frozen=True)
class HaloCostModel(CostModel):
    """Sec. 4.2 halo exchange: exact interior-surface volume (isotropic) or
    the Sec. 7.2.1 anisotropic form when per-dim ``halo`` weights are given,
    scaled by the number of exchanged ``fields``."""

    lengths: tuple[int, ...]
    halo: tuple[float, ...] | None = None
    fields: int = 1
    name = "halo"

    def cost(self, factors: Sequence[int]) -> float:
        if len(factors) != len(self.lengths):
            raise ValueError(
                f"grid rank {len(factors)} != iteration rank {len(self.lengths)}"
            )
        if self.halo is None:
            return self.fields * halo_surface_volume(self.lengths, factors)
        return self.fields * aniso_halo_volume(self.lengths, factors, self.halo)


@dataclasses.dataclass(frozen=True)
class TransposeCostModel(CostModel):
    """Sec. 7.2.2 mixed objective: anisotropic halo volume plus the
    all-to-all volume of transposes along ``transpose_dims``."""

    lengths: tuple[int, ...]
    transpose_dims: tuple[int, ...]
    halo: tuple[float, ...] | None = None
    name = "transpose"

    def cost(self, factors: Sequence[int]) -> float:
        if len(factors) != len(self.lengths):
            raise ValueError(
                f"grid rank {len(factors)} != iteration rank {len(self.lengths)}"
            )
        h = self.halo if self.halo is not None else (1.0,) * len(self.lengths)
        return aniso_halo_volume(self.lengths, factors, h) + transpose_volume(
            self.lengths, factors, self.transpose_dims
        )


_MATMUL_VOLUMES = {
    "cannon": cannon_volume,
    "summa": summa_volume,
    "pumma": pumma_volume,
    "johnson": johnson_volume,
    "solomonik": solomonik_volume,
    # COSMA candidates are scored with the 3D (Johnson) volume at the
    # candidate grid; cosma_volume() is that cost at COSMA's heuristic grid.
    "cosma": johnson_volume,
}


@dataclasses.dataclass(frozen=True)
class MatmulCostModel(CostModel):
    """Published total communication volume of one distributed matmul
    algorithm as a function of the candidate processor grid."""

    problem: MatmulProblem
    algorithm: str

    def __post_init__(self) -> None:
        if self.algorithm not in _MATMUL_VOLUMES:
            raise ValueError(
                f"unknown matmul algorithm {self.algorithm!r}; "
                f"known: {sorted(_MATMUL_VOLUMES)}"
            )

    @property
    def name(self) -> str:  # type: ignore[override]
        return self.algorithm

    def cost(self, factors: Sequence[int]) -> float:
        return _MATMUL_VOLUMES[self.algorithm](self.problem, tuple(factors))


@dataclasses.dataclass(frozen=True)
class GatherScatterCostModel(CostModel):
    """Circuit-style gather/scatter: all_gather(V) + psum_scatter(Q) ring
    volume, with an optional discount for zero-copy (ZCMEM) placement of
    the shared state (the paper's Table 2 circuit tuning)."""

    nodes_per_piece: int
    discount: float = 1.0
    name = "gather_scatter"

    def cost(self, factors: Sequence[int]) -> float:
        (procs,) = factors
        base = 2.0 * (procs - 1) * (self.nodes_per_piece * procs)
        return self.discount * base


@dataclasses.dataclass(frozen=True)
class LMStepCostModel(CostModel):
    """The auto-sharder's objective: per-step LM communication under a
    ``(dp, tp)`` or ``(dp, tp, ep)`` factorization of the chip count."""

    model: LMCommModel
    name = "lm_step"

    def cost(self, factors: Sequence[int]) -> float:
        if len(factors) == 2:
            dp, tp = factors
            ep = 1
        elif len(factors) == 3:
            dp, tp, ep = factors
        else:
            raise ValueError(f"expected (dp, tp[, ep]), got {tuple(factors)}")
        return self.model.step_volume(dp, tp, ep)
