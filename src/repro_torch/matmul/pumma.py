"""PUMMA [Choi, Walker & Dongarra 1994] — block-cyclic panel matmul.

PUMMA's defining feature versus SUMMA is its block-cyclic data-to-processor
distribution. In Mapple terms it is the *same* collective schedule with a
different mapper: the block-cyclic mapping function (Fig. 7) permutes the
device order of the mesh; the panel loop is unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.core.mapper import Mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.spmd import P
from repro_torch.core.tuples import Tup
from repro_torch.matmul.common import MatmulGrid, build_grid, sharded_matmul_wrapper
from repro_torch.matmul.summa import summa_body

AXES = ("x", "y")


def paper_mapper(machine: ProcSpace, grid_shape: tuple[int, int]) -> Mapper:
    """Block-cyclic tile->device map over the (node, gpu) hierarchy.

    Tiles cycle over nodes first (coarse), then over gpus within the node —
    the distribution PUMMA's panel rotation assumes.
    """
    nodes, gpus = machine.shape[0], machine.shape[1]

    def fn(ipoint: Tup, ispace: Tup):
        linear = ipoint.linearize(ispace)
        return machine[(linear % nodes, (linear // nodes) % gpus)]

    return Mapper("pumma_blockcyclic", fn)


def grid_for(machine: ProcSpace, device="cuda") -> MatmulGrid:
    n = machine.nprocs
    q = int(round(n ** 0.5))
    if q * q != n:
        raise ValueError(f"PUMMA (square variant) needs square device count, got {n}")
    mapper = paper_mapper(machine, (q, q))
    return build_grid(mapper, (q, q), AXES, device)


def matmul(a: torch.Tensor, b: torch.Tensor, grid: MatmulGrid,
           use_kernel: bool = False) -> torch.Tensor:
    q = grid.shape[0]
    fn = sharded_matmul_wrapper(
        grid,
        summa_body(q, use_kernel),
        in_specs=(P("x", "y"), P("x", "y")),
        out_spec=P("x", "y"),
    )
    return fn(a, b)
