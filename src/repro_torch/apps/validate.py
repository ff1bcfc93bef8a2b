"""Numeric validation: DSL-mapped meshes drive the port's kernels.

Each hook builds the Mesh from the app's *parsed Mapple program* (via
``Application.spmd_plan``) — not from the library mapper functions — so a
passing check certifies the whole pipeline: DSL text -> Mapper ->
translated device permutation -> shard_map body (through the kernels on
the card) -> matches the single-device oracle on the same device.

``full=False`` runs the JAX package's small validation sizes;
``full=True`` the registry's own problem sizes (``MATMUL_PROBLEM``,
``STENCIL_LENGTHS``, ``PENNANT_ZONES``), which is what a card is for.
Each result carries ``ms``: the wall time of each of ``repeats``
distributed runs on the same inputs, each ending in a device synchronise;
the last run's output is checked.
"""
from __future__ import annotations

import time

import torch

from repro_torch.apps import definitions
from repro_torch.kernels import ref
from repro_torch.matmul.common import MatmulGrid

#: max|out - ref| / max|ref| a matmul app may reach: fp32 accumulation in
#: another order than the oracle's (no TF32 anywhere).
MATMUL_REL_TOL = 1e-4


def _grid_for(app, procs: int, device) -> MatmulGrid:
    plan = app.spmd_plan(procs, device=device)
    return MatmulGrid(mesh=plan.mesh, axis_names=plan.axis_names)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, repeats: int):
    times = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def _max_err(out: torch.Tensor, expect: torch.Tensor) -> float:
    return float((out - expect).abs().max())


def _matmul(app, procs: int, device, full: bool, repeats: int) -> dict:
    from repro_torch.matmul import ALGORITHMS
    from repro_torch.matmul.common import make_inputs

    grid = _grid_for(app, procs, device)
    if full:
        p = definitions.MATMUL_PROBLEM
        m, k, n = p.m, p.k, p.n
    else:
        m = k = n = 32 * max(grid.shape)
    size = max(m, k, n)
    a, b = make_inputs(m, k, n, seed=0, device=device)
    out, ms = _timed(
        lambda: ALGORITHMS[app.name].matmul(a, b, grid, use_kernel=True),
        device, repeats)
    expect = ref.matmul(a, b)
    err = _max_err(out, expect)
    rel = err / float(expect.abs().max())
    return {"max_err": err, "rel_err": rel, "ms": ms,
            "ok": err < 1e-2 * size and rel <= MATMUL_REL_TOL}


def _stencil(app, procs: int, device, full: bool, repeats: int) -> dict:
    from repro_torch.science import stencil2d

    grid = _grid_for(app, procs, device)
    gx, gy = grid.shape
    nx, ny = definitions.STENCIL_LENGTHS if full else (16 * gx, 16 * gy)
    cfg = stencil2d.StencilConfig(nx=nx, ny=ny, steps=2)
    field = torch.arange(cfg.nx * cfg.ny, dtype=torch.float32,
                         device=device).reshape(cfg.nx, cfg.ny) \
        / (cfg.nx * cfg.ny)
    out, ms = _timed(lambda: stencil2d.run(field, grid, cfg), device, repeats)
    err = _max_err(out, stencil2d.reference(field, cfg))
    return {"max_err": err, "ms": ms, "ok": err < 1e-4}


def _pennant(app, procs: int, device, full: bool, repeats: int) -> dict:
    from repro_torch.science import pennant

    grid = _grid_for(app, procs, device)
    gx, gy = grid.shape
    nzx, nzy = definitions.PENNANT_ZONES if full else (16 * gx, 16 * gy)
    cfg = pennant.PennantConfig(nzx=nzx, nzy=nzy, steps=2)
    state = pennant.init_state(cfg, seed=0, device=device)
    outs, ms = _timed(lambda: pennant.run(state, grid, cfg), device, repeats)
    refs = pennant.reference(state, cfg)
    err = max(_max_err(o, r) for o, r in zip(outs, refs))
    return {"max_err": err, "ms": ms, "ok": err < 1e-4}


def _circuit(app, procs: int, device, full: bool, repeats: int) -> dict:
    from repro_torch.science import circuit

    grid = _grid_for(app, procs, device)
    cfg = circuit.CircuitConfig(
        nodes_per_piece=definitions.CIRCUIT_NODES_PER_PIECE,
        wires_per_piece=definitions.CIRCUIT_WIRES_PER_PIECE,
        pieces=procs, steps=2,
    )
    state = circuit.generate(cfg, seed=0, device=device)
    out, ms = _timed(lambda: circuit.run(state, grid, cfg), device, repeats)
    err = _max_err(out, circuit.reference(state, cfg))
    return {"max_err": err, "ms": ms, "ok": err < 1e-3}


_HOOKS = {
    "matmul": _matmul,
    "stencil": _stencil,
    "pennant": _pennant,
    "circuit": _circuit,
}


def check_batched_equivalence(app, procs: int) -> None:
    """Certify the vectorized mapper path: the batched assignment grid must
    be bit-identical to the per-point interpreter before we trust the mesh
    built from it."""
    import numpy as np

    grid_shape = app.tile_grid(procs)
    mapper = app.mapper(procs)
    batched = mapper.assignment_grid(grid_shape, use_cache=False)
    scalar = mapper.assignment_grid(
        grid_shape, vectorized=False, use_cache=False
    )
    if not np.array_equal(batched, scalar):
        raise AssertionError(
            f"{app.name}: batched mapper evaluation diverges from the "
            f"per-point path on grid {grid_shape}"
        )


def run(app, procs: int | None = None, device="cuda", full: bool = False,
        repeats: int = 1) -> dict:
    """Execute one app under its DSL-derived mesh vs its oracle."""
    if app.validate is None:
        raise KeyError(f"{app.name}: no validation hook registered")
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    n = app.procs(procs)
    check_batched_equivalence(app, n)
    return _HOOKS[app.validate](app, n, device, full, repeats)
