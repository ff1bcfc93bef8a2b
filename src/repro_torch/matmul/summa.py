"""SUMMA [Van De Geijn & Watts 1997] on a (q, q) grid via shard_map.

Each of the q panel steps broadcasts the owning column's A panel along rows
and the owning row's B panel along columns (realized as masked psum — the
SPMD broadcast idiom, here a sum over the stacked rank dim), then
accumulates the local product.
"""
from __future__ import annotations

import torch

from repro_torch.core import spmd
from repro_torch.core.mapper import Mapper, hierarchical_block_mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.spmd import P
from repro_torch.matmul.common import (
    MatmulGrid,
    build_grid,
    local_matmul,
    sharded_matmul_wrapper,
)

AXES = ("x", "y")


def paper_mapper(machine: ProcSpace, grid_shape: tuple[int, int]) -> Mapper:
    return hierarchical_block_mapper(machine, grid_shape, name="summa_hb2d")


def grid_for(machine: ProcSpace, device="cuda") -> MatmulGrid:
    n = machine.nprocs
    q = int(round(n ** 0.5))
    if q * q != n:
        raise ValueError(f"SUMMA (square variant) needs square device count, got {n}")
    mapper = paper_mapper(machine, (q, q))
    return build_grid(mapper, (q, q), AXES, device)


def summa_body(q: int, use_kernel: bool = False):
    def body(a_blk: torch.Tensor, b_blk: torch.Tensor) -> torch.Tensor:
        row = spmd.axis_index("x")
        col = spmd.axis_index("y")
        c = torch.zeros((*a_blk.shape[:-1], b_blk.shape[-1]),
                        dtype=torch.float32, device=a_blk.device)
        for t in range(q):
            # Broadcast A panel from column t along each row.
            a_panel = spmd.psum(
                spmd.where(col == t, a_blk, torch.zeros_like(a_blk)), "y")
            # Broadcast B panel from row t along each column.
            b_panel = spmd.psum(
                spmd.where(row == t, b_blk, torch.zeros_like(b_blk)), "x")
            c = c + local_matmul(a_panel, b_panel, use_kernel)
        return c.to(a_blk.dtype)

    return body


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
