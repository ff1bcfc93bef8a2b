"""Candidate mapper search spaces — the autotuner's enumeration layer.

A :class:`SearchSpace` describes, per application, the axes along which
mapper programs may vary:

  * the **grid axis** — all ordered factorizations of the processor count
    into the app's tile-grid rank (``decompose.enumerate_factorizations``),
    optionally filtered by an algorithmic validity predicate (Cannon needs
    a square grid, Solomonik a ``(q, q, c)`` grid, ...);
  * the **distribution axis** — per tile-grid axis, block-over-nodes /
    cyclic-within-node (the Fig. 12 default) or cyclic-over-nodes /
    block-within-node;
  * the **order axis** — the machine-side decompose visit order, realized
    as recorded ``swap`` ops in the mapping IR (same volume, different
    tile->device permutation, hence different fabric locality);
  * optional app-specific **option axes** (e.g. circuit's ZCMEM vs FBMEM
    placement of the shared charge region).

Every candidate materializes as a mapping-IR program — a
:class:`~repro_torch.core.pspace.ProcSpace` transformation chain
(``decompose``/``swap`` over the two-level machine) plus a mapping
function built from the Fig. 12 block/cyclic primitives — so the tuner
scores it analytically with a :class:`~repro_torch.core.commvolume.CostModel`
and evaluates it through the vectorized ``Mapper.assignment_grid`` batch
path. The winning candidate additionally renders to Mapple DSL source
(:func:`render_source`) for the ``--tune`` report.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

from repro_torch.core.commvolume import CostModel
from repro_torch.core.decompose import enumerate_factorizations, optimal_factorization
from repro_torch.core.machine import GPU, Machine
from repro_torch.core.mapper import Mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.tuples import Tup

#: Per-axis distribution choices over the two-level machine hierarchy.
BLOCK_CYCLIC = "bc"   # block over node factors, cyclic within a node (Fig. 12)
CYCLIC_BLOCK = "cb"   # cyclic over node factors, block within a node


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of a search space: a concrete mapper program, as data."""

    grid: tuple[int, ...]                         # tile grid, prod == procs
    dist: tuple[str, ...]                         # per-axis "bc" | "cb"
    order: tuple[int, ...]                        # machine-side visit order
    options: tuple[tuple[str, str], ...] = ()     # app-specific axes

    @property
    def opts(self) -> dict[str, str]:
        return dict(self.options)

    def describe(self) -> str:
        parts = ["x".join(str(g) for g in self.grid), "/".join(self.dist)]
        if self.order != tuple(range(len(self.grid))):
            parts.append("order=" + "".join(str(o) for o in self.order))
        parts.extend(f"{k}={v}" for k, v in self.options)
        return " ".join(parts)


@dataclasses.dataclass(frozen=True)
class CandidateProgram:
    """A candidate materialized as mapping IR: the transformed space, the
    node/intra-node factor split behind it, and the executable Mapper."""

    candidate: Candidate
    space: ProcSpace
    node_factors: tuple[int, ...]   # () when the machine hierarchy is flat
    proc_factors: tuple[int, ...]
    mapper: Mapper

    @property
    def hierarchical(self) -> bool:
        return bool(self.node_factors)


def node_split(machine_shape: Sequence[int],
               grid: Sequence[int]) -> tuple[int, ...] | None:
    """Factor the node count into per-axis counts dividing the tile grid.

    Returns ``None`` when the machine degenerates to one level (a single
    node, or one processor per node) or no divisible split exists — the
    candidate then uses the flat (merged) machine.
    """
    nodes, gpus = (int(s) for s in machine_shape)
    if nodes <= 1 or gpus <= 1:
        return None
    grid = tuple(int(g) for g in grid)
    nf = optimal_factorization(nodes, grid, require_divisible=True)
    if any(g % f for g, f in zip(grid, nf)):
        return None
    return nf


def _unpermute_swaps(order: Sequence[int]) -> list[tuple[int, int]]:
    """Swap sequence returning dims visited in ``order`` to identity order."""
    cur = list(order)
    swaps: list[tuple[int, int]] = []
    for i in range(len(cur)):
        j = cur.index(i)
        if j != i:
            swaps.append((i, j))
            cur[i], cur[j] = cur[j], cur[i]
    return swaps


def build_program(machine_shape: Sequence[int], cand: Candidate,
                  name: str) -> CandidateProgram:
    """Materialize a candidate as a ProcSpace IR program + Mapper.

    Hierarchical machines yield ``root(nodes, gpus).decompose(0, nf')
    .decompose(k, gf')[.swap(..)..]`` (primed tuples are in candidate
    ``order``; the swaps restore identity axis order, recording the order
    variant in the IR). Flat machines merge the two levels first.
    """
    machine_shape = tuple(int(s) for s in machine_shape)
    if len(machine_shape) != 2:
        raise ValueError(f"expected a two-level machine, got {machine_shape}")
    k = len(cand.grid)
    if sorted(cand.order) != list(range(k)):
        raise ValueError(f"order {cand.order} is not a permutation of 0..{k - 1}")
    root = Machine(GPU, shape=machine_shape)
    nf = node_split(machine_shape, cand.grid)

    if nf is None:
        flat = root.merge(0, 1)
        perm_grid = tuple(cand.grid[o] for o in cand.order)
        space = flat.decompose_with(0, perm_grid)
        for p, q in _unpermute_swaps(cand.order):
            space = space.swap(p, q)
        mapper = _flat_mapper(space, k, name)
        return CandidateProgram(cand, space, (), cand.grid, mapper)

    gf = tuple(g // f for g, f in zip(cand.grid, nf))
    perm_nf = tuple(nf[o] for o in cand.order)
    perm_gf = tuple(gf[o] for o in cand.order)
    space = root.decompose_with(0, perm_nf).decompose_with(k, perm_gf)
    for p, q in _unpermute_swaps(cand.order):
        space = space.swap(p, q)
    for p, q in _unpermute_swaps(cand.order):
        space = space.swap(k + p, k + q)
    mapper = _hierarchical_mapper(space, k, nf, gf, cand.dist, name)
    return CandidateProgram(cand, space, nf, gf, mapper)


def _flat_mapper(space: ProcSpace, k: int, name: str) -> Mapper:
    """Identity block map: tile coordinate i -> decomposed machine dim i."""

    def fn(ipoint: Tup, ispace: Tup):
        return space[tuple(ipoint[i] for i in range(k))]

    return Mapper(name, fn, spaces={"mf": space})


def _hierarchical_mapper(space: ProcSpace, k: int, nf: tuple[int, ...],
                         gf: tuple[int, ...], dist: tuple[str, ...],
                         name: str) -> Mapper:
    """Fig. 12-style two-level map with per-axis distribution choices.

    Axis i of extent g = nf[i] * gf[i] splits into a node coordinate and an
    intra-node coordinate; both variants are bijections of that axis. The
    body is pure broadcastable arithmetic, so the vectorized
    ``assignment_grid`` path evaluates it in one batched pass.
    """

    def fn(ipoint: Tup, ispace: Tup):
        uppers = []
        lowers = []
        for i in range(k):
            x = ipoint[i]
            if dist[i] == BLOCK_CYCLIC:
                uppers.append(x // gf[i])
                lowers.append(x % gf[i])
            else:
                uppers.append(x % nf[i])
                lowers.append(x // nf[i])
        return space[tuple(uppers) + tuple(lowers)]

    return Mapper(name, fn, spaces={"mf": space})


# ------------------------------------------------------------- search spaces
@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The candidate axes + cost objective for one application.

    ``cost_model(procs, options)`` returns the :class:`CostModel` scoring a
    candidate grid under the given option choices — the same object the
    ``decompose`` solver accepts as an objective.
    """

    rank: int
    cost_model: Callable[[int, dict[str, str]], CostModel]
    grid_ok: Callable[[tuple[int, ...]], bool] | None = None
    option_axes: tuple[tuple[str, tuple[str, ...]], ...] = ()
    default_grid: Callable[[int], tuple[int, ...]] | None = None
    default_options: tuple[tuple[str, str], ...] = ()
    directives: Callable[[str, dict[str, str]], str] | None = None

    # ------------------------------------------------------------- candidates
    def grids(self, procs: int) -> list[tuple[int, ...]]:
        """All valid ordered grid factorizations of ``procs``."""
        out = {
            f for f in enumerate_factorizations(procs, self.rank)
            if self.grid_ok is None or self.grid_ok(f)
        }
        return sorted(out)

    def option_combos(self) -> list[tuple[tuple[str, str], ...]]:
        if not self.option_axes:
            return [()]
        names = [n for n, _ in self.option_axes]
        choice_lists = [choices for _, choices in self.option_axes]
        return [
            tuple(zip(names, combo))
            for combo in itertools.product(*choice_lists)
        ]

    def variants(self, grid: tuple[int, ...],
                 options: tuple[tuple[str, str], ...],
                 machine_shape: Sequence[int]) -> list[Candidate]:
        """Distribution x order variants of one grid, canonicalized so
        degenerate axes (factor 1 at either machine level) do not produce
        duplicate candidates."""
        k = len(grid)
        nf = node_split(machine_shape, grid)
        if nf is None:
            dist_combos = [(BLOCK_CYCLIC,) * k]
        else:
            gf = tuple(g // f for g, f in zip(grid, nf))
            per_axis = [
                (BLOCK_CYCLIC,) if nf[i] == 1 or gf[i] == 1
                else (BLOCK_CYCLIC, CYCLIC_BLOCK)
                for i in range(k)
            ]
            dist_combos = list(itertools.product(*per_axis))
        identity = tuple(range(k))
        orders = [identity]
        reverse = tuple(reversed(identity))
        # The reversed visit order is a distinct mapping whenever it
        # permutes the grid OR the node-factor split (a uniform grid can
        # still carry an asymmetric node split, e.g. (8, 8) over 2 nodes).
        distinct = grid != tuple(reversed(grid)) or (
            nf is not None and nf != tuple(reversed(nf))
        )
        if reverse != identity and distinct:
            orders.append(reverse)
        return [
            Candidate(grid=grid, dist=d, order=o, options=options)
            for d in dist_combos for o in orders
        ]

    def default_candidate(self, procs: int) -> Candidate | None:
        """The untuned baseline (the paper's Table 2 'default' mapper)."""
        grid: tuple[int, ...] | None = None
        if self.default_grid is not None:
            try:
                grid = tuple(int(g) for g in self.default_grid(procs))
            except ValueError:
                grid = None
        if grid is None:
            grids = self.grids(procs)
            if not grids:
                return None
            grid = grids[0]
        return Candidate(
            grid=grid,
            dist=(BLOCK_CYCLIC,) * len(grid),
            order=tuple(range(len(grid))),
            options=self.default_options,
        )


# ------------------------------------------------------------- DSL rendering
def standard_directives(task: str) -> str:
    """The default directive block (FBMEM placement, depth-2 backpressure)
    used when a search space declares no app-specific directives."""
    return f"Region {task} arg0 GPU FBMEM\nBackpressure {task} 2\n"


def render_source(task: str, program: CandidateProgram,
                  directives: str | None = None) -> str:
    """Render a candidate program as Mapple DSL source.

    The rendered program re-derives the same space through the DSL: the
    ``decompose`` calls pass the wanted factor tuples as iteration lengths
    (the solver's unique optimum for ``prod(lengths) == extent`` is the
    lengths themselves), and order variants render as explicit ``swap``
    chains. The tuner verifies the parsed source reproduces the winning
    permutation bit-for-bit.
    """
    cand = program.candidate
    k = len(cand.grid)

    def tup(vals: Sequence[int]) -> str:
        inner = ", ".join(str(v) for v in vals)
        return f"({inner},)" if len(vals) == 1 else f"({inner})"

    swaps = _unpermute_swaps(cand.order)
    lines = ["m = Machine(GPU)"]
    if program.hierarchical:
        nf, gf = program.node_factors, program.proc_factors
        perm_nf = tuple(nf[o] for o in cand.order)
        perm_gf = tuple(gf[o] for o in cand.order)
        mn = f"m.decompose(0, {tup(perm_nf)})"
        lines.append(f"mn = {mn}")
        mf = f"mn.decompose({k}, {tup(perm_gf)})"
        for p, q in swaps:
            mf += f".swap({p}, {q})"
        for p, q in swaps:
            mf += f".swap({k + p}, {k + q})"
        lines.append(f"mf = {mf}")
    else:
        expr = "m.merge(0, 1).decompose(0, {})".format(
            tup(tuple(cand.grid[o] for o in cand.order))
        )
        for p, q in swaps:
            expr += f".swap({p}, {q})"
        lines.append(f"mf = {expr}")
    lines.append("")
    lines.append(f"def {task}_tuned(Tuple ipoint, Tuple ispace):")
    returns = []
    if program.hierarchical:
        for i in range(k):
            n_prim, g_prim = (
                ("block_primitive", "cyclic_primitive")
                if cand.dist[i] == BLOCK_CYCLIC
                else ("cyclic_primitive", "block_primitive")
            )
            lines.append(
                f"    n{i} = {n_prim}(ipoint, ispace, mf.size, {i}, {i})"
            )
            lines.append(
                f"    g{i} = {g_prim}(ipoint, ispace, mf.size, {i}, {k + i})"
            )
        returns = [f"n{i}" for i in range(k)] + [f"g{i}" for i in range(k)]
    else:
        for i in range(k):
            lines.append(
                f"    i{i} = block_primitive(ipoint, ispace, mf.size, {i}, {i})"
            )
        returns = [f"i{i}" for i in range(k)]
    lines.append(f"    return mf[{', '.join(returns)}]")
    lines.append("")
    lines.append(f"IndexTaskMap {task} {task}_tuned")
    body = "\n".join(lines) + "\n"
    if directives is None:
        directives = standard_directives(task)
    return body + directives
