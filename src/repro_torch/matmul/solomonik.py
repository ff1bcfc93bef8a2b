"""Solomonik's 2.5D algorithm [Solomonik & Demmel 2011] on a (q, q, c) grid.

c replicas of the Cannon schedule each execute q/c shift steps starting from
layer-offset alignments; a final psum over the replication axis combines the
partial C blocks. Mappers: the paper's ``hierarchical_block3D`` +
``linearize_cyclic`` pair (Fig. 12, Solomonik functions 1 and 2).
"""
from __future__ import annotations

import torch

from repro_torch.core import spmd
from repro_torch.core.mapper import (
    Mapper,
    hierarchical_block_mapper,
    linearize_cyclic_mapper,
)
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.spmd import P
from repro_torch.matmul.common import (
    MatmulGrid,
    build_grid,
    local_matmul,
    sharded_matmul_wrapper,
    shift,
)

AXES = ("x", "y", "z")


def grid_shape_for(nprocs: int, c: int) -> tuple[int, int, int]:
    base = nprocs // c
    q = int(round(base ** 0.5))
    if q * q * c != nprocs:
        raise ValueError(f"cannot form (q, q, {c}) grid from {nprocs} devices")
    return (q, q, c)


def paper_mapper(machine: ProcSpace, grid_shape: tuple[int, int, int]) -> Mapper:
    """Fig. 12 function 1: hierarchical block over the 3D iteration grid."""
    return hierarchical_block_mapper(machine, grid_shape, name="solomonik_hb3d")


def fallback_mapper(machine: ProcSpace) -> Mapper:
    """Fig. 12 function 2: linearize + cyclic (used for tuning comparisons)."""
    return linearize_cyclic_mapper(machine)


def grid_for(machine: ProcSpace, c: int, device="cuda",
             use_fallback_mapper: bool = False) -> MatmulGrid:
    g = grid_shape_for(machine.nprocs, c)
    mapper = (
        fallback_mapper(machine)
        if use_fallback_mapper
        else paper_mapper(machine, g)
    )
    return build_grid(mapper, g, AXES, device)


def masked_shift(x: torch.Tensor, axis: str, steps: torch.Tensor, size: int
                 ) -> torch.Tensor:
    """Shift ``x`` by a rank-dependent number of single steps (<= size-1);
    ``steps`` is a tensor over the mesh dims."""
    for s in range(size - 1):
        moved = shift(x, axis, -1, size)
        x = spmd.where(steps > s, moved, x)
    return x


def solomonik_body(q: int, c: int, use_kernel: bool = False):
    steps_per_layer = q // c

    def body(a_blk: torch.Tensor, b_blk: torch.Tensor) -> torch.Tensor:
        i = spmd.axis_index("x")
        j = spmd.axis_index("y")
        layer = spmd.axis_index("z")
        # Cannon-style alignment plus the layer offset l * (q/c).
        a = masked_shift(a_blk, "y", (i + layer * steps_per_layer) % q, q)
        b = masked_shift(b_blk, "x", (j + layer * steps_per_layer) % q, q)
        acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32,
                          device=a.device)
        for _ in range(steps_per_layer):
            acc = acc + local_matmul(a, b, use_kernel)
            a = shift(a, "y", -1, q)
            b = shift(b, "x", -1, q)
        # Combine the c partial C replicas.
        acc = spmd.psum(acc, "z")
        return acc.to(a_blk.dtype)

    return body


def matmul(a: torch.Tensor, b: torch.Tensor, grid: MatmulGrid,
           use_kernel: bool = False) -> torch.Tensor:
    q, _, c = grid.shape
    if q % c != 0:
        raise ValueError(f"2.5D requires c | q, got q={q}, c={c}")
    fn = sharded_matmul_wrapper(
        grid,
        solomonik_body(q, c, use_kernel),
        # A, B block-distributed over (x, y), replicated over z.
        in_specs=(P("x", "y"), P("x", "y")),
        out_spec=P("x", "y"),
    )
    return fn(a, b)
