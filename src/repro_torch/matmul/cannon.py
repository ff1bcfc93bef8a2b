"""Cannon's algorithm [Cannon 1969] on a (q, q) torus via shard_map.

Mapper: the paper's ``hierarchical_block2D`` (Fig. 12) — node-block over the
outer factors, cyclic over the intra-node factors. Swapping in the "runtime
heuristics" mapper (Fig. 13 strawman) changes only the Mesh device order.
"""
from __future__ import annotations

import torch

from repro_torch.core.mapper import Mapper, hierarchical_block_mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.spmd import P
from repro_torch.matmul.common import (
    MatmulGrid,
    build_grid,
    local_matmul,
    sharded_matmul_wrapper,
    shift,
    skew,
)

AXES = ("x", "y")


def paper_mapper(machine: ProcSpace, grid_shape: tuple[int, int]) -> Mapper:
    """Fig. 12: hierarchical_block2D over the (node, gpu) machine."""
    return hierarchical_block_mapper(machine, grid_shape, name="cannon_hb2d")


def grid_for(machine: ProcSpace, device="cuda") -> MatmulGrid:
    n = machine.nprocs
    q = int(round(n ** 0.5))
    if q * q != n:
        raise ValueError(f"Cannon's algorithm needs a square device count, got {n}")
    mapper = paper_mapper(machine, (q, q))
    return build_grid(mapper, (q, q), AXES, device)


def cannon_body(q: int, use_kernel: bool = False):
    def body(a_blk: torch.Tensor, b_blk: torch.Tensor) -> torch.Tensor:
        # Initial alignment: A row i shifts left i, B col j shifts up j.
        a = skew(a_blk, by_axis="x", along_axis="y", sizes=(q, q), sign=-1)
        b = skew(b_blk, by_axis="y", along_axis="x", sizes=(q, q), sign=-1)
        c = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32,
                        device=a.device)
        for _ in range(q):
            c = c + local_matmul(a, b, use_kernel)
            a = shift(a, "y", -1, q)
            b = shift(b, "x", -1, q)
        return c.to(a_blk.dtype)

    return body


def matmul(a: torch.Tensor, b: torch.Tensor, grid: MatmulGrid,
           use_kernel: bool = False) -> torch.Tensor:
    q = grid.shape[0]
    fn = sharded_matmul_wrapper(
        grid,
        cannon_body(q, use_kernel),
        in_specs=(P("x", "y"), P("x", "y")),
        out_spec=P("x", "y"),
    )
    return fn(a, b)
