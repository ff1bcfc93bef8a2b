"""The torch pricing engine on the CPU against the JAX package's NumPy engine.

``TorchBatchSimulator(device="cpu")`` runs the same tensor programs as on
the card, with the ``segment_rowmax`` kernel's plain version in place of
the kernel. It must return ``repro.sim.batch``'s numbers: within 1e-6
relative in float64 (the parity gate of ``benchmarks/sim_eval.py``; in
practice round-off), on both formulations (dense gather, segment
scatter), with the kernel reduction and without, for any placement,
across the registry's tuner variants. The card runs the same checks in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

from repro import apps as japps
from repro.core.machine import DegradedMachine as JDegraded
from repro.sim import cost as jcost
from repro_torch import apps as tapps
from repro_torch.core.machine import DegradedMachine
from repro_torch.kernels import ops
from repro_torch.sim import cost as tcost
from repro_torch.sim import torch_backend as tb
from repro_torch.sim.batch import price_stacks

# float64 against the NumPy engine: the registry's parity gate.
F64_RTOL = 1e-6
# float32 accumulates port loads in single precision: fine for ranking,
# not for the gate (the JAX package's tests/test_jax_backend.py bound).
F32_RTOL = 5e-4
# A contended machine: byte and alpha terms reduce separately (the JAX
# package's tests/test_faults.py bound).
CONTENDED_RTOL = 1e-9
APPS = list(tapps.PAPER_APPS)


def _models(name, procs=None, opts=None, degraded=None):
    """The JAX package's NumPy model and the port's torch model (CPU) at
    one (app, procs, options) point, plus a simulable grid."""
    ja, ta = japps.get(name), tapps.get(name)
    n = ta.procs(procs)
    opts = dict(ta.search_space.default_options if opts is None else opts)
    jdeg = None
    if degraded is not None:
        jdeg = JDegraded(spec=jcost.spec_for(degraded.spec.shape),
                         dead_procs=degraded.dead_procs,
                         contention=degraded.contention)
    jm = jcost.time_search_space(ja, degraded=jdeg).cost_model(n, opts)
    tm = tcost.time_search_space(ta, engine="batched-torch", device="cpu",
                                 degraded=degraded).cost_model(n, opts)
    grid = next(g for g in ta.search_space.grids(n) if _simulable(tm, g))
    return jm, tm, tuple(grid), n


def _simulable(model, grid) -> bool:
    try:
        model._validate(grid)
    except ValueError:
        return False
    return True


def _stack(model, grid, n, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    out = [model._default_assignment(grid).reshape(-1)]
    out += [rng.permutation(n) for _ in range(rows)]
    return np.stack(out)


def _rel(got, ref):
    return float((np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)).max())


@pytest.fixture(autouse=True)
def _fresh_counts():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts()["segment_rowmax"] == 0   # CPU: never the kernel
    ops.reset_launch_counts()


def _variants():
    """Every (app, option point) of the registry's tuner spaces."""
    out = []
    for name in APPS:
        for combo in tapps.get(name).search_space.option_combos():
            out.append((name, tuple(combo)))
    return out


@pytest.mark.parametrize("name,combo", _variants())
@pytest.mark.parametrize("use_kernel", [True, False])
def test_torch_engine_matches_numpy_engine(name, combo, use_kernel):
    jm, tm, grid, n = _models(name, opts=dict(combo))
    stack = _stack(tm, grid, n)
    ref = jm.batch(grid).step_times(stack)
    eng = tb.to_torch(tm.batch(grid), device="cpu", use_kernel=use_kernel)
    assert isinstance(tm.batch(grid), tb.TorchBatchSimulator)
    assert _rel(eng.step_times(stack), ref) <= F64_RTOL


@pytest.mark.parametrize("name", ["summa", "stencil", "circuit", "johnson"])
def test_scatter_mode_matches(name, monkeypatch):
    """With the dense ceiling forced to zero every schedule takes the
    segment-scatter formulation — the same numbers."""
    monkeypatch.setattr(tb, "_DENSE_CELLS_MAX", 0)
    jm, tm, grid, n = _models(name)
    eng = tm.batch(grid)
    getattr(eng.schedule, "_torch_exports", {}).clear()
    stack = _stack(tm, grid, n)
    got = eng.step_times(stack)
    assert tb._export_for(eng.schedule, eng.topology).mode == "scatter"
    assert _rel(got, jm.batch(grid).step_times(stack)) <= F64_RTOL
    getattr(eng.schedule, "_torch_exports", {}).clear()


def test_non_bijective_rows_fall_back_to_scatter():
    """Dense mode needs invertible rows; repeated target processors still
    price exactly, through the scatter formulation."""
    jm, tm, grid, n = _models("stencil")
    bad = np.tile(np.arange(n) // 2 * 2, (3, 1))
    eng = tm.batch(grid)
    assert tb._export_for(eng.schedule, eng.topology).mode == "dense"
    assert _rel(eng.step_times(bad), jm.batch(grid).step_times(bad)) <= F64_RTOL


def test_f32_is_looser_than_f64():
    """float32 drifts past float64 round-off but stays inside the ranking
    tolerance; anything needing the 1e-6 gate runs float64."""
    jm, tm, grid, n = _models("summa", procs=64)
    stack = _stack(tm, grid, n)
    ref = jm.batch(grid).step_times(stack)
    base = tm.batch(grid)
    rel32 = _rel(tb.to_torch(base, dtype="float32", device="cpu")
                 .step_times(stack), ref)
    rel64 = _rel(base.step_times(stack), ref)
    assert rel64 <= 1e-12
    assert rel32 <= F32_RTOL
    assert rel32 > rel64


def test_kernel_and_plain_reduction_agree_bit_for_bit():
    _, tm, grid, n = _models("summa", procs=64)
    base = tm.batch(grid)
    stack = _stack(tm, grid, n, rows=6)
    np.testing.assert_array_equal(
        tb.to_torch(base, device="cpu", use_kernel=True).step_times(stack),
        tb.to_torch(base, device="cpu", use_kernel=False).step_times(stack))


@pytest.mark.parametrize("name", APPS)
def test_trivial_degraded_is_bit_identical(name):
    """A mask/contention-free DegradedMachine prices exactly as healthy."""
    _, tm, grid, n = _models(name)
    _, triv, _, _ = _models(name, degraded=DegradedMachine.healthy(tm.spec))
    assert triv.cost(grid) == tm.cost(grid)
    stack = _stack(tm, grid, n)
    np.testing.assert_array_equal(triv.batch(grid).step_times(stack),
                                  tm.batch(grid).step_times(stack))


@pytest.mark.parametrize("name", ["summa", "stencil", "cannon"])
def test_contended_matches_numpy(name):
    _, tm, _, _ = _models(name)
    deg = DegradedMachine.contend(tm.spec, 0, {0: 2.5, 1: 1.7})
    if len(tm.spec.shape) > 1:
        deg = deg.merged(DegradedMachine.contend(tm.spec, 1, {1: 1.5}))
    jm, dm, grid, n = _models(name, degraded=deg)
    stack = _stack(dm, grid, n)
    for use_kernel in (True, False):
        eng = tb.to_torch(dm.batch(grid), device="cpu", use_kernel=use_kernel)
        got = eng.step_times(stack)
        np.testing.assert_allclose(got, jm.batch(grid).step_times(stack),
                                   rtol=CONTENDED_RTOL, atol=0)


def test_dead_processors_are_refused_before_pricing():
    _, tm, _, _ = _models("stencil")
    deg = DegradedMachine.fail_procs(tm.spec, [3])
    _, dm, grid, n = _models("stencil", degraded=deg)
    assign = np.arange(n).reshape(1, -1)           # touches proc 3
    with pytest.raises(ValueError, match="dead processor"):
        dm.batch(grid).step_times(assign)
    with pytest.raises(ValueError, match="dead processor"):
        dm.batch(grid).step_times_async(assign)


@pytest.mark.parametrize("name", ["summa", "pennant", "circuit"])
def test_async_result_equals_step_times(name, monkeypatch):
    """The deferred handle returns exactly ``step_times``, also when the
    stack spans several chunks."""
    monkeypatch.setattr(tb, "_MAX_DEVICE_ELEMS", 1 << 12)
    _, tm, grid, n = _models(name, procs=64)
    eng = tm.batch(grid)
    getattr(eng.schedule, "_torch_exports", {}).clear()
    stack = _stack(tm, grid, n, rows=7)
    handle = eng.step_times_async(stack)
    first = handle.result()
    np.testing.assert_array_equal(first, eng.step_times(stack))
    assert handle.result() is first                  # idempotent
    getattr(eng.schedule, "_torch_exports", {}).clear()


def test_price_stacks_routes_torch_engines_to_their_own_pricing():
    jm, tm, grid, n = _models("summa", procs=64)
    stack = _stack(tm, grid, n)
    eng = tm.batch(grid)
    assert eng.prices_independently
    (got,) = price_stacks([(eng, stack)])
    np.testing.assert_array_equal(got, eng.step_times(stack))
    assert _rel(got, jm.batch(grid).step_times(stack)) <= F64_RTOL


def test_engine_refuses_a_missing_card(monkeypatch):
    """``device="cuda"`` without a card raises; it never prices on the
    CPU instead."""
    monkeypatch.setattr(tb.torch.cuda, "is_available", lambda: False)
    _, tm, grid, _ = _models("summa")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tb.to_torch(tm.batch(grid), device="cuda")
    info = tb.platform_info("cuda")
    assert not info["available"] and not info["kernel"]
    assert tb.platform_info("cpu")["available"]


@pytest.mark.parametrize("name", APPS)
def test_export_mode_follows_the_jax_engines_rule(name, monkeypatch):
    """Dense exactly when every (slab, endpoint) pair is unique, the grid
    covers the machine and the table fits the cell ceiling (the rule of
    ``repro.sim.jax_backend._ScheduleExport``), also with the ceiling
    forced low enough to exclude some grids."""
    for ceiling in (tb._DENSE_CELLS_MAX, 1 << 12):
        monkeypatch.setattr(tb, "_DENSE_CELLS_MAX", ceiling)
        _, tm, _, n = _models(name, procs=64)
        for grid in tapps.get(name).search_space.grids(n):
            if not _simulable(tm, grid):
                continue
            eng = tm.batch(grid)
            sched, topo = eng.schedule, eng.topology
            ntiles = int(np.prod(sched.grid))
            key = sched.phase_id.astype(np.int64) * ntiles
            unique = sched.n_transfers == 0 or all(
                np.unique(key + e).size == sched.n_transfers
                for e in (sched.src, sched.dst))
            dense = (unique and ntiles == topo.nprocs
                     and sched.n_unique * ntiles <= ceiling)
            exp = tb._ScheduleExport(sched, topo)
            assert exp.mode == ("dense" if dense else "scatter"), grid


def test_repeated_endpoints_take_the_scatter_formulation():
    """An alltoall-like schedule (a tile sending twice in one slab) is
    refused by dense mode and prices exactly through scatter."""
    from repro.sim.batch import BatchSimulator as JBatch
    from repro.sim.collectives import PackedSchedule as JSched
    from repro.sim.topology import Topology as JTopo
    from repro_torch.sim.batch import BatchSimulator
    from repro_torch.sim.collectives import PackedSchedule
    from repro_torch.sim.topology import Topology

    _, tm, _, n = _models("summa")
    fields = dict(
        grid=(n,), labels=("a2a",), phase_map=np.zeros(1, np.int64),
        starts=np.array([0, 2 * n], np.int64),
        phase_id=np.zeros(2 * n, np.int64),
        src=np.repeat(np.arange(n), 2),
        dst=np.concatenate([(np.arange(n) + k) % n for k in (1, 2)])
        .reshape(2, n).T.reshape(-1),
        nbytes=np.linspace(1e3, 2e3, 2 * n),
        fold_rep=np.zeros(1, np.int64), fold_shift=np.zeros((1, 1), np.int64))
    mine = BatchSimulator(topology=Topology.from_spec(tm.spec),
                          schedule=PackedSchedule(**fields), compute_s=1e-9)
    theirs = JBatch(topology=JTopo.from_spec(jcost.spec_for(tm.spec.shape)),
                    schedule=JSched(**fields), compute_s=1e-9)
    eng = tb.to_torch(mine, device="cpu")
    assert tb._export_for(eng.schedule, eng.topology).mode == "scatter"
    stack = _stack(tm, (n,), n)
    assert _rel(eng.step_times(stack), theirs.step_times(stack)) <= F64_RTOL
