"""PENNANT proxy [Ferenbaugh 2015] (paper app 9) — staggered-grid hydro.

The real PENNANT is unstructured-mesh Lagrangian hydrodynamics; this proxy
keeps its computational character — staggered zone/node variables,
predictor-corrector update, gather (zone->node forces) and scatter
(node->zone volumes) phases — on a structured 2D mesh so the distributed
data movement (halo exchange of zone pressures and corner forces) is the
same pattern Mapple's decompose optimizes.

State (zones are cells, nodes are cell corners):
  zone: density rho, specific internal energy e, pressure p (ideal gas)
  node: velocity (u, v) at cell corners (staggered)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import spmd
from repro_torch.core.decompose import cached_optimal
from repro_torch.core.mapper import block_mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.spmd import P
from repro_torch.kernels.ref import edge_pad
from repro_torch.matmul.common import MatmulGrid, build_grid

AXES = ("x", "y")
GAMMA = 1.4


@dataclasses.dataclass(frozen=True)
class PennantConfig:
    nzx: int = 32          # zones in x
    nzy: int = 32          # zones in y
    dt: float = 1e-3
    dx: float = 1.0
    steps: int = 4


def grid_for(machine: ProcSpace, cfg: PennantConfig, device="cuda") -> MatmulGrid:
    # Memoized + integrality-constrained (shards must tile the zone arrays).
    g = cached_optimal(machine.nprocs, (cfg.nzx, cfg.nzy), require_divisible=True)
    m1 = machine.merge(0, 1) if machine.ndim == 2 else machine
    m2 = m1.decompose_with(0, g)
    mapper = block_mapper(m2, "pennant_block")
    return build_grid(mapper, tuple(int(x) for x in g), AXES, device)


def init_state(cfg: PennantConfig, seed: int = 0, device="cuda"):
    """rho, e ~ 1 + 0.1 * U[0, 1), u = v = 0, drawn from a seeded
    ``torch.Generator`` on ``device`` (the JAX package draws the same
    distributions from ``jax.random``; the numbers differ)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (cfg.nzx, cfg.nzy)
    rho = 1.0 + 0.1 * torch.rand(shape, generator=gen, device=device)
    e = 1.0 + 0.1 * torch.rand(shape, generator=gen, device=device)
    u = torch.zeros(shape, device=device)
    v = torch.zeros(shape, device=device)
    return rho, e, u, v


def _halo1(f: torch.Tensor, axis_name: str, axis_size: int, dim: int):
    """1-deep edge-replicated halo along one sharded (negative) block dim."""
    idx = spmd.axis_index(axis_name)
    lo_face = f.narrow(dim, 0, 1)
    hi_face = f.narrow(dim, f.shape[dim] - 1, 1)
    fwd = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    bwd = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    from_prev = spmd.ppermute(hi_face, axis_name, fwd)
    from_next = spmd.ppermute(lo_face, axis_name, bwd)
    from_prev = spmd.where(idx == 0, lo_face, from_prev)
    from_next = spmd.where(idx == axis_size - 1, hi_face, from_next)
    return torch.cat([from_prev, f, from_next], dim=dim)


def _padded(f, gx, gy):
    """Edge-replicated 1-halo in both dims (corners via sequential pad)."""
    f = _halo1(f, "x", gx, -2)
    f = _halo1(f, "y", gy, -1)
    return f


def _hydro_step(rho, e, u, v, cfg: PennantConfig, pad):
    # --- zone pressure (ideal gas EOS)
    p = (GAMMA - 1.0) * rho * e
    # --- gather phase: pressure gradient forces at nodes need neighbours
    p_pad = pad(p)
    fx = -(p_pad[..., 2:, 1:-1] - p_pad[..., :-2, 1:-1]) / (2.0 * cfg.dx)
    fy = -(p_pad[..., 1:-1, 2:] - p_pad[..., 1:-1, :-2]) / (2.0 * cfg.dx)
    # --- node (corner) velocity update
    u = u + cfg.dt * fx / rho
    v = v + cfg.dt * fy / rho
    # --- scatter phase: velocity divergence back onto zones
    u_pad = pad(u)
    v_pad = pad(v)
    div = (
        (u_pad[..., 2:, 1:-1] - u_pad[..., :-2, 1:-1])
        + (v_pad[..., 1:-1, 2:] - v_pad[..., 1:-1, :-2])
    ) / (2.0 * cfg.dx)
    # --- Lagrangian density/energy update (compressible flow)
    rho = rho * (1.0 - cfg.dt * div)
    e = e - cfg.dt * p * div / torch.clamp(rho, min=1e-6)
    return rho, e, u, v


def hydro_step(rho, e, u, v, cfg: PennantConfig, gx: int, gy: int):
    """One step on stacked blocks, halos exchanged between ranks."""
    return _hydro_step(rho, e, u, v, cfg, lambda f: _padded(f, gx, gy))


def pennant_body(cfg: PennantConfig, grid_shape):
    gx, gy = grid_shape

    def body(rho, e, u, v):
        carry = (rho, e, u, v)
        for _ in range(cfg.steps):
            carry = hydro_step(*carry, cfg, gx, gy)
        return carry

    return body


def run(state, grid: MatmulGrid, cfg: PennantConfig):
    fn = spmd.shard_map(
        pennant_body(cfg, grid.shape),
        grid.mesh,
        in_specs=(P("x", "y"),) * 4,
        out_specs=(P("x", "y"),) * 4,
    )
    return fn(*state)


def reference(state, cfg: PennantConfig):
    """Single-device oracle (identical math, edge-replicate padding)."""
    carry = tuple(state)
    for _ in range(cfg.steps):
        carry = _hydro_step(*carry, cfg, edge_pad)
    return carry
