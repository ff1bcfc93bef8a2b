"""The port's fault remapper against the JAX package's, on the CPU.

Mirrors the degraded-pricing and remap contracts of ``tests/test_faults.py``
on ``repro_torch``: the same failures go through ``repro.search.remap`` on
the NumPy engine (``batched``) and through ``repro_torch.search.remap`` on
the torch engine (``batched-torch``, CPU, the ``segment_rowmax`` kernel's
plain version). The port must choose ``repro``'s sub-machine and winner,
with placed seconds within 1e-6 relative (the pricer's parity gate), and
keep the remap's own contracts: zero work on dead processors, never worse
than the stale plan, the audit equal to the event engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro import apps as japps
from repro.core.machine import DegradedMachine as JDegraded
from repro.search.remap import remap_plan as j_remap_plan
from repro.search.remap import submachine_options as j_submachine_options
from repro.search.tuner import tune_app as j_tune_app
from repro.sim.cost import SimulatedTimeCostModel as JModel
from repro.sim.cost import spec_for as j_spec_for
from repro.sim.cost import time_tuned_app as j_time_tuned_app
from repro_torch import apps
from repro_torch.core.machine import DegradedMachine, MachineSpec
from repro_torch.search import remap_plan, submachine_options
from repro_torch.search.remap import degraded_from_failures, price_on_degraded
from repro_torch.search.tuner import tune_app
from repro_torch.sim.collectives import build_phases
from repro_torch.sim.cost import (
    SimulatedTimeCostModel,
    default_assignment,
    pattern_with_options,
    spec_for,
    time_tuned_app,
)
from repro_torch.sim.engine import FaultEvent, NodeFailure, simulate_steps
from repro_torch.sim.topology import Topology

SPEC24 = MachineSpec(shape=(2, 4), level_names=("node", "gpu"))
PLACED_RTOL = 1e-6
# A contended machine: byte and alpha terms reduce separately (the JAX
# package's tests/test_faults.py bound).
CONTENDED_RTOL = 1e-9
TORCH = dict(engine="batched-torch", device="cpu")
APPS = list(apps.PAPER_APPS)


def _model(app, *, engine="batched", degraded=None, procs=None):
    n = procs or app.default_procs
    spec = spec_for(app.machine_shape(n))
    return SimulatedTimeCostModel(
        pattern=app.collective, spec=spec, step_flops=float(app.step_flops(n)),
        engine=engine, device="cpu", degraded=degraded), n, spec


def _default_grid(app, n):
    return app.search_space.default_grid(n) if app.search_space.default_grid \
        else app.search_space.grids(n)[0]


def _j(view: DegradedMachine) -> JDegraded:
    """The same degraded view in the JAX package's types."""
    return JDegraded(spec=j_spec_for(view.spec.shape), dead_procs=view.dead_procs,
                     contention=view.contention)


def _stale(name, n):
    """The healthy winner in each package: the stale plans to remap."""
    return (tune_app(time_tuned_app(apps.get(name)), n),
            j_tune_app(j_time_tuned_app(japps.get(name)), n))


def _remap_both(name, degraded, *, stale=(None, None), mode="warm", procs=None):
    """One remap through the port on the torch engine and through repro on
    the NumPy engine; the port's result first."""
    mine = remap_plan(apps.get(name), stale[0], degraded, mode=mode, procs=procs,
                      **TORCH)
    theirs = j_remap_plan(japps.get(name), stale[1], _j(degraded), mode=mode,
                          procs=procs)
    return mine, theirs


def _assert_same_remap(mine, theirs):
    """The same sub-machine, winner and physical placement; placed seconds
    within the pricer's gate, candidate by candidate."""
    assert mine.sub_shape == theirs.sub_shape
    assert mine.proc_map == theirs.proc_map and mine.procs == theirs.procs
    assert mine.report.best.candidate.describe() == \
        theirs.report.best.candidate.describe()
    np.testing.assert_array_equal(mine.placement, theirs.placement)
    by_name = {s.candidate.describe(): s.placed_cost
               for s in theirs.report.leaderboard}
    assert sorted(by_name) == sorted(s.candidate.describe()
                                     for s in mine.report.leaderboard)
    for s in mine.report.leaderboard:
        want = by_name[s.candidate.describe()]
        assert (s.placed_cost is None) == (want is None)
        if want is not None:
            assert s.placed_cost == pytest.approx(want, rel=PLACED_RTOL)
    assert mine.degraded_step_s == pytest.approx(theirs.degraded_step_s,
                                                 rel=PLACED_RTOL)
    assert mine.stale_step_s == theirs.stale_step_s or \
        mine.stale_step_s == pytest.approx(theirs.stale_step_s, rel=PLACED_RTOL)


# --------------------------------------------------------- pricing parity
@pytest.mark.parametrize("engine", ["batched", "event"])
def test_trivial_degraded_bit_identical_registry(engine):
    """A mask/contention-free DegradedMachine prices bit-identically to the
    healthy path, and to repro, on the host engines — every registry app.
    The torch engine's case is ``test_torch_pricer.py``'s
    ``test_trivial_degraded_is_bit_identical``."""
    for app in apps.iter_apps():
        model, n, spec = _model(app, engine=engine)
        triv, _, _ = _model(app, engine=engine,
                            degraded=DegradedMachine.healthy(spec))
        grid = _default_grid(app, n)
        theirs = JModel(pattern=japps.get(app.name).collective,
                        spec=j_spec_for(spec.shape),
                        step_flops=float(app.step_flops(n)), engine=engine)
        assert triv.cost(grid) == model.cost(grid) == theirs.cost(grid), \
            (app.name, engine)


@pytest.mark.parametrize("name", ["summa", "stencil"])
def test_contended_torch_matches_numpy(name):
    app = apps.get(name)
    _, n, spec = _model(app)
    deg = DegradedMachine.contend(spec, 0, {0: 2.5, 1: 1.7})
    dn, _, _ = _model(app, degraded=deg)
    dt, _, _ = _model(app, engine="batched-torch", degraded=deg)
    jn = JModel(pattern=japps.get(name).collective, spec=j_spec_for(spec.shape),
                step_flops=float(app.step_flops(n)), degraded=_j(deg))
    grid = _default_grid(app, n)
    assign = dn._default_assignment(grid)
    tn = jn.batch(grid).step_time(assign)
    assert dn.batch(grid).step_time(assign) == tn
    assert dt.batch(grid).step_time(assign) == pytest.approx(tn, rel=CONTENDED_RTOL)


@pytest.mark.parametrize("engine", ["batched", "batched-torch", "event"])
def test_dead_processors_are_unplaceable(engine):
    app = apps.get("stencil")
    _, n, spec = _model(app)
    deg = DegradedMachine.fail_procs(spec, [3])
    grid = _default_grid(app, n)
    assign = default_assignment(spec.shape, grid)   # touches proc 3
    model, _, _ = _model(app, engine=engine, degraded=deg)
    with pytest.raises(ValueError, match="dead processor"):
        if engine == "event":
            model.simulate(grid, assign)
        else:
            model.batch(grid).step_times(
                np.asarray(assign, dtype=np.int64).reshape(1, -1), fold=False)


# ------------------------------------------------------------------- remap
def test_degraded_from_failures_folds_evidence():
    spec = SPEC24
    view = degraded_from_failures(spec, [
        NodeFailure(time=1.0, step=3, procs=(1,)),
        FaultEvent(t=0.5, kind="node-death", procs=(2,)),
        FaultEvent(t=0.1, kind="link-slowdown", factor=2.0),  # weather
        5,
        DegradedMachine.contend(spec, 0, {0: 2.0}),
    ])
    assert view.dead_procs == (1, 2, 5)
    assert view.port_contention(0) == (2.0, 1.0)
    ready = DegradedMachine.fail_procs(spec, [7])
    assert degraded_from_failures(spec, ready) is ready
    assert degraded_from_failures(spec, 4).dead_procs == (4,)
    with pytest.raises(ValueError, match="different machine"):
        degraded_from_failures(
            spec, DegradedMachine.healthy(
                MachineSpec(shape=(4, 2), level_names=("node", "gpu"))))


@pytest.mark.parametrize("shape,dead", [((2, 4), [3]), ((4, 4), [1, 6, 15]),
                                        ((8, 1), [7]), ((3, 8), [0, 9])])
def test_submachine_options_rank_avoid_dead_and_match_repro(shape, dead):
    spec = spec_for(shape)
    deg = DegradedMachine.fail_procs(spec, dead)
    opts = list(submachine_options(deg))
    assert opts == list(j_submachine_options(_j(deg)))
    if shape == (2, 4):
        # 7 survive but nodes are uneven (3+4): the best *regular* grid is
        # 2 nodes x 3 procs = 6.
        assert opts[0][0] == (2, 3) and len(opts[0][1]) == 6
    gpus = shape[1]
    for (a, g), pm in opts:
        assert len(pm) == a * g
        assert not set(pm) & set(deg.dead_procs)
        # node-major: logical node i' lives inside ONE physical node
        for i in range(a):
            assert len({pm[i * g + k] // gpus for k in range(g)}) == 1


@pytest.mark.parametrize("name", APPS)
def test_remap_places_zero_work_on_masked_procs_and_matches_repro(name):
    """Every registry app, one dead proc: the remapped plan never touches
    it, and the torch engine's remap is repro's."""
    app = apps.get(name)
    n = app.default_procs
    deg = DegradedMachine.fail_procs(spec_for(app.machine_shape(n)), [n - 1])
    mine, theirs = _remap_both(name, deg)
    placed = set(mine.placement.reshape(-1).tolist())
    assert not placed & set(deg.dead_procs)
    assert placed <= set(deg.alive_procs())
    assert np.isfinite(mine.degraded_step_s)
    assert mine.procs == mine.sub_shape[0] * mine.sub_shape[1]
    _assert_same_remap(mine, theirs)


@pytest.mark.parametrize("name", ["stencil", "summa"])
def test_remap_warm_start_never_worse_than_stale(name):
    """On a contention-only degradation (stale plan still placeable) the
    remap, seeded with the stale winner, never prices worse than keeping
    the stale placement, and restricts Phase 1 to the seeded points."""
    app = apps.get(name)
    n = app.default_procs
    deg = DegradedMachine.contend(spec_for(app.machine_shape(n)), 0, {0: 3.0})
    mine, theirs = _remap_both(name, deg, stale=_stale(name, n))
    assert np.isfinite(mine.stale_step_s)
    assert mine.degraded_step_s <= mine.stale_step_s * (1 + 1e-12)
    assert "restricted search" in mine.report.note
    _assert_same_remap(mine, theirs)


def test_remap_stale_plan_on_dead_proc_prices_inf():
    app = apps.get("stencil")
    n = app.default_procs
    deg = DegradedMachine.fail_procs(spec_for(app.machine_shape(n)), [0])
    mine, theirs = _remap_both("stencil", deg, stale=_stale("stencil", n))
    assert mine.stale_step_s == float("inf") == theirs.stale_step_s
    assert np.isfinite(mine.degraded_step_s)
    _assert_same_remap(mine, theirs)


def test_remap_audit_price_matches_event_engine():
    """The batched audit of the physically translated placement agrees
    with the exact event queue on the same degraded machine."""
    app = apps.get("stencil")
    n = app.default_procs
    spec = spec_for(app.machine_shape(n))
    deg = DegradedMachine.fail_procs(spec, [0]).merged(
        DegradedMachine.contend(spec, 0, {1: 2.0}))
    mine, theirs = _remap_both("stencil", deg)
    _assert_same_remap(mine, theirs)
    best = mine.report.best.candidate
    pattern = pattern_with_options(app.collective, dict(best.options))
    grid = tuple(int(g) for g in best.grid)
    compute_s = float(app.step_flops(mine.procs)) / (mine.procs * spec.peak_flops)
    phases = build_phases(pattern, grid, mine.placement, elem_bytes=4)
    t_event = simulate_steps(
        phases, Topology.from_spec(spec, degraded=deg),
        compute_s=compute_s, steps=3).per_step_time()
    t_batched = price_on_degraded(app, deg, best, mine.placement, procs=mine.procs)
    assert t_batched == pytest.approx(t_event, abs=1e-9)
    assert t_batched == mine.degraded_step_s


def test_remap_warm_vs_cold_same_submachine():
    app = apps.get("summa")
    n = app.default_procs
    deg = DegradedMachine.fail_procs(spec_for(app.machine_shape(n)), [1])
    stale = _stale("summa", n)
    warm, j_warm = _remap_both("summa", deg, stale=stale, mode="warm")
    cold, j_cold = _remap_both("summa", deg, stale=stale, mode="cold")
    assert warm.sub_shape == cold.sub_shape
    assert warm.mode == "warm" and cold.mode == "cold"
    # cold runs the full enumeration: it can only match or beat warm
    assert cold.degraded_step_s <= warm.degraded_step_s * (1 + 1e-12)
    _assert_same_remap(warm, j_warm)
    _assert_same_remap(cold, j_cold)
    with pytest.raises(ValueError, match="mode"):
        remap_plan(app, stale[0], deg, mode="lukewarm", **TORCH)


def test_remap_refuses_when_nothing_survives_feasibly():
    app = apps.get("cannon")
    # A space that needs at least a 2x2 square grid: 3 survivors cannot
    # host it on any regular sub-machine.
    space = dataclasses.replace(
        app.search_space, grid_ok=lambda f: f[0] == f[1] >= 2)
    strict = dataclasses.replace(app, search_space=space)
    deg = DegradedMachine.fail_procs(spec_for(app.machine_shape(4)), [0])
    with pytest.raises(ValueError, match="sub-machine"):
        remap_plan(strict, None, deg, procs=4, **TORCH)
    bare = dataclasses.replace(app, search_space=None)
    with pytest.raises(ValueError, match="search space"):
        remap_plan(bare, None, deg, **TORCH)


def test_remap_on_the_card_refuses_without_one(monkeypatch):
    """``device="cuda"`` (the default) without a card raises before any
    pricing; the remap never prices on the CPU or the NumPy engine
    instead."""
    from repro_torch.sim import torch_backend as tb

    monkeypatch.setattr(tb.torch.cuda, "is_available", lambda: False)
    app = apps.get("stencil")
    deg = DegradedMachine.fail_procs(spec_for(app.machine_shape(8)), [7])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        remap_plan(app, None, deg, engine="batched-torch")
