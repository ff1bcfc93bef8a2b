"""Johnson's 3D algorithm [Agarwal et al. 1995] on a (q1, q2, q3) grid.

A is sharded (m over x, k over z) and replicated over y; B (k over z,
n over y) replicated over x. One local product + one reduction (psum over
z) produces C (m over x, n over y). Mapper: the paper's
``conditional_linearize3D`` (Fig. 12).
"""
from __future__ import annotations

import torch

from repro_torch.core import spmd
from repro_torch.core.mapper import Mapper, conditional_linearize3d_mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.spmd import P
from repro_torch.matmul.common import (
    MatmulGrid,
    build_grid,
    local_matmul,
    sharded_matmul_wrapper,
)

AXES = ("x", "y", "z")


def cube_grid(nprocs: int) -> tuple[int, int, int]:
    q = round(nprocs ** (1.0 / 3.0))
    if q ** 3 != nprocs:
        raise ValueError(f"Johnson's algorithm needs a cubic device count, got {nprocs}")
    return (q, q, q)


def paper_mapper(machine: ProcSpace) -> Mapper:
    return conditional_linearize3d_mapper(machine)


def grid_for(machine: ProcSpace, device="cuda") -> MatmulGrid:
    g = cube_grid(machine.nprocs)
    mapper = paper_mapper(machine)
    return build_grid(mapper, g, AXES, device)


def johnson_body(use_kernel: bool = False):
    def body(a_blk: torch.Tensor, b_blk: torch.Tensor) -> torch.Tensor:
        c_partial = local_matmul(a_blk, b_blk, use_kernel)
        c = spmd.psum(c_partial, "z")
        return c.to(a_blk.dtype)

    return body


def matmul(a: torch.Tensor, b: torch.Tensor, grid: MatmulGrid,
           use_kernel: bool = False) -> torch.Tensor:
    fn = sharded_matmul_wrapper(
        grid,
        johnson_body(use_kernel),
        # A: m over x, k over z (replicated over y); B: k over z, n over y.
        in_specs=(P("x", "z"), P("z", "y")),
        out_spec=P("x", "y"),
    )
    return fn(a, b)
