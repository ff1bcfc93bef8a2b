"""The port's Mapple pipeline maps every tile exactly as the JAX package does.

For all nine apps at their default processor counts and at 16 and 64, the
port's ``to_spmd`` device permutation and mapper IR must be identical to
``repro``'s (the copied NumPy-only layers are faithful), and the port's
mesh must place tile ``t`` on virtual device ``perm[t]``.
"""
import numpy as np
import pytest
import torch

import repro.apps as japps
import repro.apps.run as jrun
import repro_torch.apps as tapps
import repro_torch.apps.run as trun
from repro.core import GPU as JGPU, Machine as JMachine
from repro.matmul import cannon as jcannon
from repro.matmul import runtime_heuristic_mapper as j_heuristic
from repro_torch.core import GPU, Machine, spmd
from repro_torch.core.spmd import P
from repro_torch.core.translate import MappingPlan
from repro_torch.matmul import cannon as tcannon
from repro_torch.matmul import runtime_heuristic_mapper as t_heuristic

APPS = list(japps.PAPER_APPS)


def test_same_nine_apps():
    assert tuple(tapps.PAPER_APPS) == tuple(japps.PAPER_APPS)
    assert tapps.names() == japps.names()


@pytest.mark.parametrize("procs", [None, 16, 64])
@pytest.mark.parametrize("name", APPS)
def test_permutation_and_ir_match_reference(name, procs):
    japp, tapp = japps.get(name), tapps.get(name)
    n = japp.procs(procs)
    try:
        grid = japp.tile_grid(n)
    except ValueError:
        # The app takes no such processor count: the port refuses it too.
        with pytest.raises(ValueError):
            tapp.tile_grid(n)
        return
    assert tapp.tile_grid(n) == grid
    assert tapp.mapple_source(n) == japp.mapple_source(n)
    jplan = japp.spmd_plan(n, devices=[])
    tplan = tapp.spmd_plan(n, device="cpu")
    assert np.array_equal(tplan.meta["device_permutation"],
                          jplan.meta["device_permutation"])
    assert tplan.meta["mapper_ir"] == jplan.meta["mapper_ir"]
    assert tapp.mapper(n).describe() == japp.mapper(n).describe()
    assert tplan.meta["tile_grid"] == jplan.meta["tile_grid"]
    assert (tplan.memory_kinds, tplan.donate, tplan.backpressure) == \
        (jplan.memory_kinds, jplan.donate, jplan.backpressure)
    assert sorted(tplan.in_specs) == sorted(jplan.in_specs)
    assert np.array_equal(tplan.mesh.device_ids,
                          np.asarray(jplan.meta["device_permutation"]).reshape(grid))


@pytest.mark.parametrize("name", APPS)
def test_analysis_rows_match_reference(name):
    """``run --all`` prints the same table as the JAX package's runner."""
    keys = ("procs", "grid", "mapper", "bijective", "mapple_loc",
            "lowlevel_loc", "comm_volume", "step_flops", "backpressure",
            "memory_kinds", "donate", "operands", "mapper_ir")
    jrow = jrun.analyze(japps.get(name), None)
    trow = trun.analyze(tapps.get(name), None, device="cpu")
    assert {k: trow[k] for k in keys} == {k: jrow[k] for k in keys}


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 4)])
def test_fig13_runtime_heuristic_mapper_matches_reference(shape):
    q = int(round((shape[0] * shape[1]) ** 0.5))
    if q * q != shape[0] * shape[1]:
        q = None
    grid = (shape[0] * shape[1],) if q is None else (q, q)
    jperm = j_heuristic(JMachine(JGPU, shape=shape)).tile_permutation(
        grid, shape[0] * shape[1])
    tperm = t_heuristic(Machine(GPU, shape=shape)).tile_permutation(
        grid, shape[0] * shape[1])
    assert np.array_equal(tperm, jperm)
    if q is not None:
        jspec = jcannon.paper_mapper(JMachine(JGPU, shape=shape), grid)
        tspec = tcannon.paper_mapper(Machine(GPU, shape=shape), grid)
        assert np.array_equal(tspec.tile_permutation(grid, q * q),
                              jspec.tile_permutation(grid, q * q))


@pytest.mark.parametrize("name", APPS)
def test_placement_puts_tile_t_on_device_perm_t(name):
    app = tapps.get(name)
    plan = app.spmd_plan(device="cpu")
    grid = plan.meta["tile_grid"]
    perm = plan.meta["device_permutation"]
    # A global tensor whose every tile holds its own flat tile index.
    tiles = torch.arange(int(np.prod(grid)), dtype=torch.float32).reshape(grid)
    glob = tiles
    for d in range(len(grid)):
        glob = glob.repeat_interleave(2, dim=d)
    stacked = spmd.split(glob, P(*plan.axis_names), plan.mesh)
    placed = spmd.placement(plan.mesh, stacked)
    assert sorted(placed) == list(range(len(perm)))
    for t, dev in enumerate(perm):
        assert bool((placed[int(dev)] == t).all()), (name, t, dev)


def test_region_memory_kinds_become_shardings():
    """circuit's ``Region circuit arg1 CPU ZCMEM`` is a host tensor; its
    ``arg0 GPU FBMEM`` lives on the mesh's device."""
    plan = tapps.get("circuit").spmd_plan(device="cpu")
    assert isinstance(plan, MappingPlan)
    x = torch.arange(16.0)
    dev = plan.sharding("arg0").place(x)
    host = plan.sharding("arg1").place(x)
    assert plan.sharding("arg1").memory_kind == "pinned_host"
    assert host.device.type == "cpu" and host.is_contiguous()
    assert dev.shape == host.shape == (8, 2)
    torch.testing.assert_close(host, dev)
    with pytest.raises(KeyError):
        plan.sharding("nope")


def _library_grids():
    """(name, port grid from ``grid_for``, the JAX package's mapper for the
    same grid) for every module, as tests/test_distributed.py builds them."""
    from repro.core import block_mapper as j_block
    from repro.matmul import cosma as jcosma, johnson as jjohnson
    from repro.matmul import pumma as jpumma, solomonik as jsolo
    from repro.matmul import summa as jsumma
    from repro.science import stencil2d as jst
    from repro_torch.core.commvolume import MatmulProblem
    from repro_torch.matmul import cosma, johnson, pumma, solomonik, summa
    from repro_torch.science import stencil2d

    m4, m8, m24 = (Machine(GPU, shape=s) for s in ((2, 2), (8, 1), (2, 4)))
    j4, j8, j24 = (JMachine(JGPU, shape=s) for s in ((2, 2), (8, 1), (2, 4)))
    rows = [
        ("cannon", tcannon.grid_for(m4, "cpu"), jcannon.paper_mapper(j4, (2, 2))),
        ("summa", summa.grid_for(m4, "cpu"), jsumma.paper_mapper(j4, (2, 2))),
        ("pumma", pumma.grid_for(m4, "cpu"), jpumma.paper_mapper(j4, (2, 2))),
        ("johnson", johnson.grid_for(m8, "cpu"), jjohnson.paper_mapper(j8)),
        ("solomonik", solomonik.grid_for(m24, c=2, device="cpu"),
         jsolo.paper_mapper(j24, (2, 2, 2))),
        ("solomonik", solomonik.grid_for(m24, c=2, device="cpu",
                                         use_fallback_mapper=True),
         jsolo.fallback_mapper(j24)),
        ("cosma", cosma.grid_for(m8, MatmulProblem(16, 32, 24), "cpu"),
         jcosma.paper_mapper(j8, (2, 2, 2))),
    ]
    cfg = stencil2d.StencilConfig(nx=32, ny=48)
    for greedy in (False, True):
        shape = jst.choose_grid(8, jst.StencilConfig(nx=32, ny=48),
                                use_greedy=greedy)
        jmapper = j_block(j24.merge(0, 1).decompose_with(0, shape))
        rows.append(("stencil", stencil2d.grid_for(m24, cfg, "cpu",
                                                   use_greedy=greedy), jmapper))
    return rows


def test_library_grids_match_reference_and_compute():
    """Each module's ``grid_for`` builds the mesh the JAX package's library
    mapper gives, and the matmul algorithms on it compute A @ B."""
    from repro_torch.matmul import ALGORITHMS
    from repro_torch.matmul.common import make_inputs

    a, b = make_inputs(16, 24, 32, seed=1, device="cpu")
    expect = a.double() @ b.double()
    for name, grid, jmapper in _library_grids():
        n = int(np.prod(grid.shape))
        assert np.array_equal(grid.mesh.device_ids.reshape(-1),
                              jmapper.tile_permutation(grid.shape, n)), name
        if name in ALGORITHMS:
            out = ALGORITHMS[name].matmul(a, b, grid, use_kernel=True)
            assert float((out - expect).abs().max()) < 1e-4, name


def test_owned_tiles_matches_reference():
    from repro.core import cyclic_mapper as j_cyclic
    from repro.core.translate import owned_tiles as j_owned
    from repro_torch.core import cyclic_mapper
    from repro_torch.core.translate import owned_tiles

    mine = owned_tiles(cyclic_mapper(Machine(GPU, shape=(2, 4))), (6, 8), 8)
    ref = j_owned(j_cyclic(JMachine(JGPU, shape=(2, 4))), (6, 8), 8)
    assert mine == ref
