"""2D stencil benchmark [Van der Wijngaart & Mattson 2014] (paper app 8).

A 5-point Jacobi stencil over an (X, Y) grid, distributed over a 2D
processor grid chosen by Mapple's ``decompose`` (the paper's Sec. 6.3
workload). Halo exchange is a pair of ppermutes per dimension; the
communication volume is exactly the quantity decompose minimizes, so this
app is the end-to-end validation of the primitive.

Each step's sweep over the halo-padded blocks of all ranks is one launch
of the stencil kernel on the card (``kernels.ops.stencil_interior``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import spmd
from repro_torch.core.decompose import cached_optimal, greedy_factorization
from repro_torch.core.mapper import block_mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.spmd import P
from repro_torch.kernels import ops, ref
from repro_torch.matmul.common import MatmulGrid, build_grid

AXES = ("x", "y")


@dataclasses.dataclass(frozen=True)
class StencilConfig:
    nx: int
    ny: int
    halo: int = 1
    steps: int = 4


def choose_grid(nprocs: int, cfg: StencilConfig, *, use_greedy: bool = False
                ) -> tuple[int, int]:
    """The experiment knob of Sec. 6.3: decompose vs Algorithm 1."""
    if use_greedy:
        g = greedy_factorization(nprocs, 2)
    else:
        # Memoized + integrality-constrained: shard_map needs every factor
        # to divide its extent (the paper's l_m/w_m in N constraint).
        g = cached_optimal(nprocs, (cfg.nx, cfg.ny), require_divisible=True)
    return (int(g[0]), int(g[1]))


def grid_for(machine: ProcSpace, cfg: StencilConfig, device="cuda",
             use_greedy: bool = False) -> MatmulGrid:
    shape = choose_grid(machine.nprocs, cfg, use_greedy=use_greedy)
    m2 = machine.merge(0, 1).decompose_with(0, shape) if machine.ndim == 2 \
        else machine.decompose_with(0, shape)
    mapper = block_mapper(m2, "stencil_block")
    return build_grid(mapper, shape, AXES, device)


def _take(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    return x.narrow(dim, lo, hi - lo)


def _exchange(field: torch.Tensor, axis_name: str, axis_size: int, dim: int,
              halo: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Receive the neighbouring halo slabs along one (negative) block dim."""
    idx = spmd.axis_index(axis_name)
    # Send my low face to the left neighbour; receive from the right, etc.
    lo_face = _take(field, dim, 0, halo)
    hi_face = _take(field, dim, field.shape[dim] - halo, field.shape[dim])
    right = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    left = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    from_left = spmd.ppermute(hi_face, axis_name, right)
    from_right = spmd.ppermute(lo_face, axis_name, left)
    # Zero-flux boundary at the global edges.
    from_left = spmd.where(idx == 0, lo_face, from_left)
    from_right = spmd.where(idx == axis_size - 1, hi_face, from_right)
    return from_left, from_right


def _edge_rows(x: torch.Tensor, halo: int) -> torch.Tensor:
    """Edge-replicate ``halo`` rows above and below (``mode="edge"``)."""
    top = x[..., :1, :].expand(*x.shape[:-2], halo, x.shape[-1])
    bot = x[..., -1:, :].expand(*x.shape[:-2], halo, x.shape[-1])
    return torch.cat([top, x, bot], dim=-2)


def stencil_body(grid_shape: tuple[int, int], cfg: StencilConfig):
    gx, gy = grid_shape

    def body(field: torch.Tensor) -> torch.Tensor:
        f = field
        for _ in range(cfg.steps):
            up, down = _exchange(f, "x", gx, -2, cfg.halo)
            left, right = _exchange(f, "y", gy, -1, cfg.halo)
            fx = torch.cat([up, f, down], dim=-2)
            f_pad = torch.cat(
                [_edge_rows(left, cfg.halo), fx, _edge_rows(right, cfg.halo)],
                dim=-1,
            )
            f = ops.stencil_interior(f_pad)
        return f

    return body


def run(field: torch.Tensor, grid: MatmulGrid, cfg: StencilConfig
        ) -> torch.Tensor:
    body = stencil_body(grid.shape, cfg)  # type: ignore[arg-type]
    fn = spmd.shard_map(body, grid.mesh, in_specs=(P("x", "y"),),
                        out_specs=P("x", "y"))
    return fn(field)


def reference(field: torch.Tensor, cfg: StencilConfig) -> torch.Tensor:
    """Plain single-device oracle with zero-flux (edge-replicate) boundaries."""
    f = field
    for _ in range(cfg.steps):
        f = ref.stencil(f)
    return f
