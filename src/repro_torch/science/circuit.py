"""Circuit simulation [Bauer et al. 2012] (paper app 7) — distributed.

The Legion circuit benchmark: a graph of nodes (voltage, charge,
capacitance) and wires (resistance, current) partitioned into pieces.
Each timestep:

  1. calc_new_currents:  I_w = (V_src - V_dst) / R_w
  2. distribute_charge:  Q_n += dt * (sum of incident currents)
  3. update_voltages:    V_n += Q_n / C_n; Q_n = 0

Pieces own a contiguous slab of nodes and the wires sourced in the slab;
wires crossing piece boundaries make this communication-bound. The SPMD
translation expresses the cross-piece reduction as all_gather(V) + a
per-rank scatter-add (one batched ``scatter_add_`` over the rank dim) +
psum_scatter(Q) — the all-reduce decomposition whose placement Mapple's
Region/decompose directives control.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import spmd
from repro_torch.core.mapper import block_mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.spmd import P
from repro_torch.matmul.common import MatmulGrid, build_grid

AXES = ("x",)


@dataclasses.dataclass(frozen=True)
class CircuitConfig:
    nodes_per_piece: int = 64
    wires_per_piece: int = 96
    pieces: int = 4
    pct_internal: float = 0.9      # fraction of wires that stay in-piece
    dt: float = 1e-2
    steps: int = 4

    @property
    def n_nodes(self) -> int:
        return self.nodes_per_piece * self.pieces

    @property
    def n_wires(self) -> int:
        return self.wires_per_piece * self.pieces


@dataclasses.dataclass
class CircuitState:
    voltage: torch.Tensor      # (n_nodes,)
    charge: torch.Tensor       # (n_nodes,)
    capacitance: torch.Tensor  # (n_nodes,)
    src: torch.Tensor          # (n_wires,) int64
    dst: torch.Tensor          # (n_wires,) int64
    resistance: torch.Tensor   # (n_wires,)


def generate(cfg: CircuitConfig, seed: int = 0, device="cuda") -> CircuitState:
    """The circuit graph, drawn with numpy from ``seed`` (the same numbers
    as the JAX package's ``circuit.generate``)."""
    rng = np.random.default_rng(seed)
    n, w = cfg.n_nodes, cfg.n_wires
    src = np.empty(w, np.int64)
    dst = np.empty(w, np.int64)
    for p in range(cfg.pieces):
        lo = p * cfg.nodes_per_piece
        for i in range(cfg.wires_per_piece):
            wi = p * cfg.wires_per_piece + i
            src[wi] = lo + rng.integers(cfg.nodes_per_piece)
            if rng.random() < cfg.pct_internal:
                dst[wi] = lo + rng.integers(cfg.nodes_per_piece)
            else:
                dst[wi] = rng.integers(n)
    voltage = rng.normal(size=n).astype(np.float32)
    capacitance = rng.uniform(1.0, 2.0, size=n).astype(np.float32)
    resistance = rng.uniform(1.0, 4.0, size=w).astype(np.float32)

    def put(x):
        return torch.from_numpy(x).to(device)

    return CircuitState(
        voltage=put(voltage),
        charge=torch.zeros(n, dtype=torch.float32, device=device),
        capacitance=put(capacitance),
        src=put(src),
        dst=put(dst),
        resistance=put(resistance),
    )


def grid_for(machine: ProcSpace, cfg: CircuitConfig, device="cuda") -> MatmulGrid:
    m1 = machine.merge(0, 1) if machine.ndim == 2 else machine
    mapper = block_mapper(m1, "circuit_block")
    return build_grid(mapper, (cfg.pieces,), AXES, device)


def circuit_body(cfg: CircuitConfig, n_pieces: int):
    n_nodes = cfg.n_nodes

    def body(volt, charge, cap, src, dst, res):
        volt_loc, charge_loc = volt, charge
        for _ in range(cfg.steps):
            volt_full = spmd.all_gather(volt_loc, "x", dim=0, tiled=True)
            cur = (volt_full.gather(-1, src) - volt_full.gather(-1, dst)) / res
            acc = torch.zeros((n_pieces, n_nodes), dtype=torch.float32,
                              device=volt.device)
            acc.scatter_add_(-1, src, -cfg.dt * cur)
            acc.scatter_add_(-1, dst, cfg.dt * cur)
            acc_loc = spmd.psum_scatter(acc, "x", scatter_dimension=0,
                                        tiled=True)
            charge_loc = charge_loc + acc_loc
            volt_loc = volt_loc + charge_loc / cap
            charge_loc = torch.zeros_like(charge_loc)
        return volt_loc

    return body


def run(state: CircuitState, grid: MatmulGrid, cfg: CircuitConfig
        ) -> torch.Tensor:
    fn = spmd.shard_map(
        circuit_body(cfg, grid.shape[0]),
        grid.mesh,
        in_specs=(P("x"),) * 6,
        out_specs=P("x"),
    )
    return fn(
        state.voltage, state.charge, state.capacitance,
        state.src, state.dst, state.resistance,
    )


def reference(state: CircuitState, cfg: CircuitConfig) -> torch.Tensor:
    """Plain single-device oracle."""
    volt, charge = state.voltage, state.charge
    for _ in range(cfg.steps):
        cur = (volt[state.src] - volt[state.dst]) / state.resistance
        charge = charge.index_add(0, state.src, -cfg.dt * cur)
        charge = charge.index_add(0, state.dst, cfg.dt * cur)
        volt = volt + charge / state.capacitance
        charge = torch.zeros_like(charge)
    return volt
