"""The port's copies of the simulator's NumPy modules against ``repro.sim``.

``repro_torch.sim.{collectives,topology,batch,engine,price_cache,cost}``
are copies of the JAX package's NumPy-only modules with their imports
renamed. These tests feed both packages the same apps, grids and
numpy-seeded placements and require identical results, bit for bit, over
the nine paper apps at 16 and 64 processors.
"""
import numpy as np
import pytest

from repro import apps as japps
from repro.sim import batch as jbatch
from repro.sim import collectives as jcoll
from repro.sim import cost as jcost
from repro.sim import price_cache as jpc
from repro.sim import topology as jtopo
from repro_torch import apps as tapps
from repro_torch.sim import batch as tbatch
from repro_torch.sim import collectives as tcoll
from repro_torch.sim import cost as tcost
from repro_torch.sim import price_cache as tpc
from repro_torch.sim import topology as ttopo

APPS = list(tapps.PAPER_APPS)
PROCS = (16, 64)
SCHEDULE_FIELDS = ("phase_map", "starts", "phase_id", "src", "dst", "nbytes",
                   "fold_rep", "fold_shift")


def _point(name, procs):
    """Both packages' time models at one feasible (app, procs, grid)."""
    ja, ta = japps.get(name), tapps.get(name)
    n = ta.procs(procs)
    jspace, tspace = jcost.time_search_space(ja), tcost.time_search_space(ta)
    opts = dict(tspace.default_options)
    jm, tm = jspace.cost_model(n, opts), tspace.cost_model(n, opts)
    for grid in ta.search_space.grids(n):
        try:
            tm._validate(grid)
        except ValueError:
            continue
        return jm, tm, tuple(grid), n
    pytest.skip(f"{name} has no simulable grid at {n} procs")


def _stack(n, rows=5, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(rows)])


@pytest.mark.parametrize("procs", PROCS)
@pytest.mark.parametrize("name", APPS)
def test_packed_schedule_and_bucket_times_match(name, procs):
    jm, tm, grid, n = _point(name, procs)
    js = jcoll.packed_schedule(jm.pattern, grid, elem_bytes=jm.elem_bytes)
    ts = tcoll.packed_schedule(tm.pattern, grid, elem_bytes=tm.elem_bytes)
    assert ts.grid == js.grid and ts.labels == js.labels
    for field in SCHEDULE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field),
                                      err_msg=field)
    jt, tt = jtopo.Topology.from_spec(jm.spec), ttopo.Topology.from_spec(tm.spec)
    assert (tt.alphas, tt.betas, tt.port_strides) == \
        (jt.alphas, jt.betas, jt.port_strides)
    a = _stack(n, rows=2, seed=procs)
    src = a[:, js.src].reshape(-1)
    dst = a[:, js.dst].reshape(-1)
    nbytes = np.tile(js.nbytes, 2)
    bucket = (np.repeat(np.arange(2), js.n_transfers) * js.n_unique
              + np.tile(js.phase_id, 2))
    args = (src, dst, nbytes, bucket, 2 * js.n_unique)
    np.testing.assert_array_equal(tt.bucket_times(*args), jt.bucket_times(*args))


@pytest.mark.parametrize("procs", PROCS)
@pytest.mark.parametrize("name", APPS)
def test_numpy_step_times_and_cache_keys_match(name, procs):
    jm, tm, grid, n = _point(name, procs)
    stack = np.concatenate([tm._default_assignment(grid).reshape(1, -1),
                            _stack(n, seed=procs + 1)])
    for fold in (True, False):
        np.testing.assert_array_equal(
            tm.batch(grid).step_times(stack, fold=fold, incremental=fold),
            jm.batch(grid).step_times(stack, fold=fold, incremental=fold))
    assert tm.cost(grid) == jm.cost(grid)
    assert tm.price_table_key(grid) == jm.price_table_key(grid)
    for row in stack:
        assert tm.price_row_key(grid, row) == jm.price_row_key(grid, row)
        np.testing.assert_array_equal(
            tbatch.canonical_assignment(row, tm.spec.shape),
            jbatch.canonical_assignment(row, jm.spec.shape))


@pytest.mark.parametrize("procs", PROCS)
@pytest.mark.parametrize("name", APPS)
def test_simulate_app_matches(name, procs):
    """The event engine through the whole pipeline: same timeline."""
    mine = tcost.simulate_app(tapps.get(name), procs).summary()
    theirs = jcost.simulate_app(japps.get(name), procs).summary()
    assert mine == theirs


def test_price_cache_digests_and_files_match(tmp_path):
    parts = (b"pattern", b"(8, 8)", b"spec")
    assert tpc.digest(*parts) == jpc.digest(*parts)
    table, row = tpc.digest(b"table"), tpc.digest(b"row")
    tpc.PriceCache(tmp_path / "torch").put(table, row, 1.25e-3)
    jpc.PriceCache(tmp_path / "jax").put(table, row, 1.25e-3)
    files = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    assert jpc.PriceCache(tmp_path / "torch").get(table, row) == 1.25e-3


def test_value_tags_name_the_torch_engine():
    model = tcost.time_search_space(tapps.get("summa")).cost_model(16, {})
    tags = {engine: tcost.SimulatedTimeCostModel(
        pattern=model.pattern, spec=model.spec, step_flops=model.step_flops,
        engine=engine, dtype=dtype).value_tag
        for engine, dtype in (("batched", "float64"), ("event", "float64"),
                              ("batched-torch", "float64"))}
    assert tags == {"batched": "numpy-f64", "event": "event-f64",
                    "batched-torch": "torch-f64"}
    f32 = tcost.SimulatedTimeCostModel(
        pattern=model.pattern, spec=model.spec, step_flops=model.step_flops,
        engine="batched-torch", dtype="float32")
    assert f32.value_tag == "torch-f32"
    with pytest.raises(ValueError, match="batched-torch"):
        tcost.SimulatedTimeCostModel(pattern=model.pattern, spec=model.spec,
                                     step_flops=1.0, engine="batched-jax")
