"""Mapping functions and the Mapper object (paper Figs. 3, 4, 7, 12).

A *mapping function* takes an iteration point and the iteration space and
returns a :class:`Processor` (root coordinates). A :class:`Mapper` bundles
the transformed processor space(s) with the function, and can evaluate the
full iteration grid into a device-assignment array (what the JAX
translation layer consumes).

Grid evaluation is vectorized: the mapping function is called ONCE with a
batched :class:`Tup` covering every iteration point, and the processor
spaces replay their recorded transformation IR with pure NumPy index
arithmetic (:meth:`ProcSpace.to_root_batch`). Bodies that are
data-dependent on the iteration point (e.g. branch on ``ipoint``) cannot
broadcast; those fall back automatically to the per-point interpreter.
Evaluated grids are cached per ``ispace`` so bijectivity checks, mesh
permutations and owned-tile queries share one evaluation.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.pspace import ProcSpace, Processor, ProcessorBatch
from repro_torch.core.tuples import Tup

MapFn = Callable[[Tup, Tup], Processor]


@dataclasses.dataclass
class Mapper:
    """A named index mapping: iteration space -> processor space."""

    name: str
    fn: MapFn
    spaces: dict[str, ProcSpace] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    _grid_cache: dict[tuple[int, ...], np.ndarray] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    #: Which path produced the most recent (non-cached) grid evaluation:
    #: "vectorized" or "per-point". Lets callers detect a silent fallback —
    #: benchmarks/mapping_eval.py fails if a vectorizable mapper regressed
    #: to the per-point interpreter.
    last_eval_path: str | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def __call__(self, ipoint: Sequence[int], ispace: Sequence[int]) -> Processor:
        return self.fn(Tup(ipoint), Tup(ispace))

    # -------------------------------------------------------------- analysis
    def assignment_grid(
        self,
        ispace: Sequence[int],
        *,
        vectorized: bool = True,
        use_cache: bool = True,
    ) -> np.ndarray:
        """Flat device id for every iteration point; shape = ispace.

        Vectorized (one batched call of ``fn``) with automatic per-point
        fallback for data-dependent bodies. The result is cached per
        ``ispace`` and marked read-only; pass ``use_cache=False`` to force
        a fresh evaluation (benchmarks), ``vectorized=False`` to force the
        per-point path (equivalence checks). The per-point path never
        touches the cache — otherwise a scalar-vs-batch cross-check could
        be handed the cached vectorized grid and compare it with itself.
        """
        key = tuple(int(s) for s in ispace)
        use_cache = use_cache and vectorized
        if use_cache:
            cached = self._grid_cache.get(key)
            if cached is not None:
                return cached
        grid = None
        if vectorized:
            try:
                grid = self._grid_vectorized(key)
            except Exception:
                grid = None  # data-dependent body: per-point fallback below
        self.last_eval_path = "vectorized" if grid is not None else "per-point"
        if grid is None:
            grid = self._grid_per_point(key)
        grid.flags.writeable = False
        if use_cache:
            self._grid_cache[key] = grid
        return grid

    def _grid_vectorized(self, ispace: tuple[int, ...]) -> np.ndarray | None:
        ipoints = Tup.grid(ispace)
        result = self.fn(ipoints, Tup(ispace))
        if not isinstance(result, (Processor, ProcessorBatch)):
            return None
        flat = np.asarray(result.flat, dtype=np.int64)
        n = ipoints.batch_size
        if flat.ndim == 0:  # body ignored ipoint entirely: constant map
            flat = np.full(n, int(flat), dtype=np.int64)
        if flat.shape != (n,):
            return None
        return flat.reshape(ispace).copy()

    def _grid_per_point(self, ispace: tuple[int, ...]) -> np.ndarray:
        ispace_t = Tup(ispace)
        out = np.empty(ispace, dtype=np.int64)
        for pt in itertools.product(*(range(s) for s in ispace)):
            out[pt] = self.fn(Tup(pt), ispace_t).flat
        return out

    def is_bijective_on(self, ispace: Sequence[int], nprocs: int) -> bool:
        grid = self.assignment_grid(ispace)
        return grid.size == nprocs and len(np.unique(grid)) == nprocs

    def tile_permutation(self, ispace: Sequence[int], nprocs: int) -> np.ndarray:
        """Row-major tile order -> device id permutation (must be bijective).

        This is the object the JAX translation uses to build the Mesh: JAX
        assigns block i of a sharded axis to mesh position i, so realizing an
        arbitrary Mapple map means permuting the device list.
        """
        grid = self.assignment_grid(ispace)
        flat = grid.reshape(-1)
        if len(np.unique(flat)) != nprocs or flat.size != nprocs:
            raise ValueError(
                f"mapper {self.name} is not a bijection from {tuple(ispace)} "
                f"onto {nprocs} processors; cannot realize as a mesh permutation"
            )
        return flat

    # --------------------------------------------------------- introspection
    def describe(self) -> str:
        """The mapper as an inspectable program: its name plus the recorded
        transformation IR of every processor space it closes over."""
        lines = [f"mapper {self.name}"]
        for nm, sp in self.spaces.items():
            lines.append(f"  {nm} = {sp.describe()}")
        return "\n".join(lines)


# ------------------------------------------------------------ Fig. 7 library
def block_mapper(m: ProcSpace, name: str = "block") -> Mapper:
    """blockND: idx = ipoint * m.size / ispace (Fig. 3 / Fig. 7)."""

    def fn(ipoint: Tup, ispace: Tup) -> Processor:
        idx = ipoint * m.size / ispace
        return m[tuple(idx)]

    return Mapper(name, fn, spaces={"m": m})


def cyclic_mapper(m: ProcSpace, name: str = "cyclic") -> Mapper:
    """cyclicND: idx = ipoint % m.size."""

    def fn(ipoint: Tup, ispace: Tup) -> Processor:
        idx = ipoint % m.size
        return m[tuple(idx)]

    return Mapper(name, fn, spaces={"m": m})


def block_cyclic_mapper(m: ProcSpace, name: str = "blockcyclic") -> Mapper:
    """block-cyclic: idx = ipoint / m.size % m.size (Fig. 7)."""

    def fn(ipoint: Tup, ispace: Tup) -> Processor:
        idx = ipoint / m.size % m.size
        return m[tuple(idx)]

    return Mapper(name, fn, spaces={"m": m})


def linear_cyclic_mapper(m2d: ProcSpace, name: str = "linearCyclic") -> Mapper:
    """Fig. 4: merge the 2D space to 1D, round-robin the linearized point."""
    m1 = m2d.merge(0, 1)

    def fn(ipoint: Tup, ispace: Tup) -> Processor:
        linearized = ipoint.linearize(ispace)
        return m1[(linearized % m1.size[0],)]

    return Mapper(name, fn, spaces={"m": m2d, "m1": m1})


# --------------------------------------------------------- Fig. 12 primitives
def block_primitive(ipoint: Tup, ispace: Tup, psize: Tup, dim1: int, dim2: int):
    return ipoint[dim1] * psize[dim2] // ispace[dim1]


def cyclic_primitive(ipoint: Tup, ispace: Tup, psize: Tup, dim1: int, dim2: int):
    return ipoint[dim1] % psize[dim2]


def hierarchical_block_mapper(
    m2d: ProcSpace, ispace: Sequence[int], name: str = "hierarchical_block"
) -> Mapper:
    """Fig. 12 hierarchical_block{2,3}D, generalized to any rank.

    decompose the node dim against the iteration space, then decompose the
    per-node processor dim against the *per-node* sub iteration space; block
    over the node factors, cyclic over the intra-node factors.
    """
    k = len(ispace)
    m_nodes = m2d.decompose(0, ispace)                   # k node factors + gpu dim
    node_factors = Tup(m_nodes.shape[:k])
    sub_ispace = Tup(ispace) / node_factors              # per-node sub space
    m_full = m_nodes.decompose(k, tuple(sub_ispace))     # + k gpu factors
    psize = m_full.size

    def fn(ipoint: Tup, ispace_t: Tup) -> Processor:
        upper = tuple(
            block_primitive(ipoint, ispace_t, psize, i, i) for i in range(k)
        )
        lower = tuple(
            cyclic_primitive(ipoint, ispace_t, psize, i, i + k) for i in range(k)
        )
        return m_full[upper + lower]

    return Mapper(name, fn, spaces={"m": m2d, "mf": m_full})


def _column_major_linearize(ipoint: Tup, ispace: Tup):
    """Column-major (first-dim-fastest) linearization at ANY matching rank.

    Replaces the old hardcoded rank-3 expression, which guarded ``ipoint[2]``
    but silently dropped dims beyond the third and assumed rank-3 strides.
    """
    if len(ipoint) != len(ispace):
        raise ValueError(
            f"rank mismatch: point rank {len(ipoint)} vs space rank {len(ispace)}"
        )
    linearized, stride = 0, 1
    for d in range(len(ipoint)):
        linearized = linearized + ipoint[d] * stride
        stride = stride * ispace[d]
    return linearized


def linearize_cyclic_mapper(m2d: ProcSpace, name: str = "linearize_cyclic") -> Mapper:
    """Fig. 12 Solomonik's function 2: column-major linearize, cyclic over
    node then gpu dims of the original 2D space."""

    def fn(ipoint: Tup, ispace: Tup) -> Processor:
        linearized = _column_major_linearize(ipoint, ispace)
        node_idx = linearized % m2d.size[0]
        gpu_idx = (linearized // m2d.size[0]) % m2d.size[1]
        return m2d[(node_idx, gpu_idx)]

    return Mapper(name, fn, spaces={"m": m2d})


def special_linearize3d_mapper(m2d: ProcSpace, name: str = "special_linearize3D") -> Mapper:
    """Fig. 12 COSMA mapper: decompose nodes as equally as possible, then
    linearize with the resulting grid strides, cyclic over nodes."""
    m5 = m2d.decompose(0, (1, 1, 1))  # equal split (all lengths equal)

    def fn(ipoint: Tup, ispace: Tup) -> Processor:
        gx = m5.size[2]
        gy = m5.size[1]
        linearized = ipoint[0] + ipoint[1] * gx + ipoint[2] * gx * gy
        return m2d[(linearized % m2d.size[0], 0)]

    return Mapper(name, fn, spaces={"m": m2d, "m5": m5})


def conditional_linearize3d_mapper(
    m2d: ProcSpace, name: str = "conditional_linearize3D"
) -> Mapper:
    """Fig. 12 Johnson's mapper: stride by the larger of ispace[0]/ispace[2]."""

    def fn(ipoint: Tup, ispace: Tup) -> Processor:
        grid_size = ispace[0] if ispace[0] > ispace[2] else ispace[2]
        linearized = (
            ipoint[0] + ipoint[1] * grid_size + ipoint[2] * grid_size * grid_size
        )
        return m2d[(linearized % m2d.size[0], 0)]

    return Mapper(name, fn, spaces={"m": m2d})


def transformed_block_mapper(m: ProcSpace, name: str) -> Mapper:
    """block over an arbitrarily transformed space (block1D_x etc.)."""
    return block_mapper(m, name)
