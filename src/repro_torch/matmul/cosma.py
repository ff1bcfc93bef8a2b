"""COSMA [Kwasniewski et al. 2019] — communication-optimal grid matmul.

COSMA derives a near-I/O-optimal processor grid from the red-blue pebbling
bound and executes a 3D (Johnson-style) schedule on it. Here the grid comes
from :func:`repro_torch.core.commvolume.cosma_grid` (greedy largest-extent
split, the COSMA heuristic) and the device order from the paper's
``special_linearize3D`` mapper (Fig. 12).
"""
from __future__ import annotations

import torch

from repro_torch.core.commvolume import MatmulProblem, cosma_grid
from repro_torch.core.mapper import Mapper, special_linearize3d_mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.spmd import P
from repro_torch.core.tuples import Tup
from repro_torch.matmul.common import MatmulGrid, build_grid, sharded_matmul_wrapper
from repro_torch.matmul.johnson import johnson_body

AXES = ("x", "y", "z")


def paper_mapper(machine: ProcSpace, grid: tuple[int, int, int] | None = None
                 ) -> Mapper:
    """Fig. 12 ``special_linearize3D``: linearize with the COSMA grid's
    strides, cyclic over the node dimension.

    The paper derives the strides from ``m_2d.decompose(0, (1,1,1))`` because
    COSMA picks the machine decomposition equal to its own grid; we pass the
    actual grid so the map stays a bijection for non-balanced grids too.
    """
    if grid is None:
        return special_linearize3d_mapper(machine)
    gx, gy, _ = grid
    nodes = machine.shape[0]

    def fn(ipoint: Tup, ispace: Tup):
        linearized = ipoint[0] + ipoint[1] * gx + ipoint[2] * gx * gy
        return machine[(linearized % nodes, (linearized // nodes) % machine.shape[1])]

    return Mapper("cosma_special_linearize3D", fn)


def grid_for(machine: ProcSpace, problem: MatmulProblem, device="cuda"
             ) -> MatmulGrid:
    g = cosma_grid(problem, machine.nprocs)
    mapper = paper_mapper(machine, g)
    return build_grid(mapper, g, AXES, device)


def matmul(a: torch.Tensor, b: torch.Tensor, grid: MatmulGrid,
           use_kernel: bool = False) -> torch.Tensor:
    fn = sharded_matmul_wrapper(
        grid,
        johnson_body(use_kernel),
        in_specs=(P("x", "z"), P("z", "y")),
        out_spec=P("x", "y"),
    )
    return fn(a, b)
