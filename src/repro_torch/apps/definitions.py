"""The nine paper applications, registered declaratively.

Six matmul algorithms (Sec. 6.1-6.2) and three scientific workloads
(Sec. 6.3). Each definition carries:

  * the Mapple DSL mapper program (Fig. 12 of the paper), rendered for a
    given processor count;
  * machine / tile-grid policies scaling the paper's 2-node running
    example to arbitrary processor counts;
  * the closed-form communication-volume model (Sec. 4.2 / published
    matmul costs) the benchmarks reproduce analytically;
  * the Table 2 tuning experiment (default vs tuned mapper volumes);
  * the low-level raw-JAX baseline fixture whose LoC Table 1 compares.

Importing this module populates ``repro_torch.apps.registry``. The
counterpart of ``repro.apps.definitions``.
"""
from __future__ import annotations

import math

from repro_torch.core.commvolume import (
    GatherScatterCostModel,
    HaloCostModel,
    MatmulCostModel,
    MatmulProblem,
    cannon_volume,
    cosma_grid,
    cosma_volume,
    halo_surface_volume,
    johnson_volume,
    solomonik_volume,
    summa_volume,
)
from repro_torch.core.decompose import (
    cached_optimal,
    greedy_factorization,
    optimal_factorization,
)
from repro_torch.apps.registry import (
    MATMUL,
    SCIENCE,
    Application,
    cube_grid,
    register,
    replicated_grid,
    square_grid,
    two_level_machine,
)
from repro_torch.search.space import SearchSpace
from repro_torch.sim.collectives import CollectivePattern

# Default problem sizes (scaled-down analogues of the paper's runs).
MATMUL_PROBLEM = MatmulProblem(4096, 4096, 4096)
STENCIL_LENGTHS = (1024, 8192)      # 1:8 aspect — where decompose pays off
PENNANT_ZONES = (2048, 16384)
PENNANT_FIELDS = 3          # p, u, v halos exchanged per hydro step
CIRCUIT_NODES_PER_PIECE = 64
CIRCUIT_WIRES_PER_PIECE = 96


def _matmul_machine(procs: int) -> tuple[int, int]:
    """(nodes, gpus) for the 2D matmul algorithms; the paper's default
    machine is 2 nodes x 2 GPUs at four processors."""
    return two_level_machine(procs, 2 if procs <= 8 else 4)


def _science_machine(procs: int) -> tuple[int, int]:
    return two_level_machine(procs, 4)


def _stencil_grid(lengths):
    lengths = tuple(int(x) for x in lengths)

    def grid(procs: int) -> tuple[int, ...]:
        # Memoized hot path: the runner / tuner re-derive this grid often.
        # Integrality-constrained like the science/ launchers, so the
        # analysis grid always matches the grid the kernels execute on.
        return tuple(int(x) for x in cached_optimal(
            procs, lengths, require_divisible=True))

    return grid


# --------------------------------------------------------------- Mapple DSL
# Fig. 12 mapper programs, rendered per processor count. Directives mirror
# the raw fixtures' memory/donation/backpressure choices exactly.

HB2D_TEMPLATE = """\
m = Machine(GPU)
mn = m.decompose(0, ({gx}, {gy}))
mf = mn.decompose(2, ({gx} / mn.size[0], {gy} / mn.size[1]))

def {task}_map(Tuple ipoint, Tuple ispace):
    n0 = block_primitive(ipoint, ispace, mf.size, 0, 0)
    n1 = block_primitive(ipoint, ispace, mf.size, 1, 1)
    g0 = cyclic_primitive(ipoint, ispace, mf.size, 0, 2)
    g1 = cyclic_primitive(ipoint, ispace, mf.size, 1, 3)
    return mf[n0, n1, g0, g1]

IndexTaskMap {task} {task}_map
"""


def _cannon_mapple(procs: int) -> str:
    gx, gy = square_grid(procs)
    return (
        HB2D_TEMPLATE.format(task="cannon", gx=gx, gy=gy)
        + "Region cannon arg0 GPU FBMEM\n"
        + "Region cannon arg1 GPU FBMEM\n"
        + "GarbageCollect cannon arg2\n"
        + "Backpressure cannon 1\n"
    )


def _summa_mapple(procs: int) -> str:
    gx, gy = square_grid(procs)
    return (
        HB2D_TEMPLATE.format(task="summa", gx=gx, gy=gy)
        + "Region summa arg0 GPU FBMEM\n"
        + "Region summa arg1 GPU FBMEM\n"
        + "Backpressure summa 2\n"
    )


def _pumma_mapple(procs: int) -> str:
    return """\
m = Machine(GPU)
m1 = m.merge(0, 1)

def pumma_map(Tuple ipoint, Tuple ispace):
    linearized = ipoint.linearize(ispace)
    return m1[linearized % m1.size[0]]

IndexTaskMap pumma pumma_map
Region pumma arg0 GPU FBMEM
Backpressure pumma 2
"""


def _johnson_mapple(procs: int) -> str:
    return """\
m = Machine(GPU)

def johnson_map(Tuple ipoint, Tuple ispace):
    grid_size = ispace[0] > ispace[2] ? ispace[0] : ispace[2]
    linearized = ipoint[0] + ipoint[1] * grid_size + ipoint[2] * grid_size * grid_size
    return m[linearized % m.size[0], 0]

IndexTaskMap johnson johnson_map
Region johnson arg0 GPU FBMEM
Backpressure johnson 2
"""


def _solomonik_mapple(procs: int) -> str:
    return """\
m = Machine(GPU)

def solomonik_map(Tuple ipoint, Tuple ispace):
    linearized = ipoint[0] + ispace[0] * ipoint[1] + ispace[0] * ispace[1] * ipoint[2]
    node_idx = linearized % m.size[0]
    gpu_idx = linearized / m.size[0] % m.size[1]
    return m[node_idx, gpu_idx]

IndexTaskMap solomonik solomonik_map
Region solomonik arg0 GPU FBMEM
GarbageCollect solomonik arg2
Backpressure solomonik 1
"""


def _cosma_mapple(procs: int) -> str:
    return """\
m = Machine(GPU)
m5 = m.decompose(0, (1, 1, 1))

def cosma_map(Tuple ipoint, Tuple ispace):
    linearized = ipoint[0] + ipoint[1] * m5.size[2] + ipoint[2] * m5.size[2] * m5.size[1]
    return m[linearized % m.size[0], 0]

IndexTaskMap cosma cosma_map
Region cosma arg0 GPU FBMEM
Backpressure cosma 2
"""


DECOMPOSE_TEMPLATE = """\
m = Machine(GPU)
m2 = m.merge(0, 1).decompose(0, ({nx}, {ny}))

def {task}_map(Tuple ipoint, Tuple ispace):
    idx = ipoint * m2.size / ispace
    return m2[*idx]

IndexTaskMap {task} {task}_map
Region {task} arg0 GPU FBMEM
Backpressure {task} 2
"""


def _stencil_mapple(procs: int) -> str:
    nx, ny = STENCIL_LENGTHS
    return DECOMPOSE_TEMPLATE.format(task="stencil", nx=nx, ny=ny)


def _pennant_mapple(procs: int) -> str:
    nx, ny = PENNANT_ZONES
    return DECOMPOSE_TEMPLATE.format(task="pennant", nx=nx, ny=ny)


def _circuit_mapple(procs: int) -> str:
    return """\
m = Machine(GPU)
m1 = m.merge(0, 1)

def circuit_map(Tuple ipoint, Tuple ispace):
    idx = ipoint * m1.size / ispace
    return m1[*idx]

IndexTaskMap circuit circuit_map
Region circuit arg0 GPU FBMEM
Region circuit arg1 CPU ZCMEM
Backpressure circuit 2
"""


# ------------------------------------------------------------ volume models
def _cannon_tuning(procs: int) -> tuple[float, float]:
    v = cannon_volume(MATMUL_PROBLEM, square_grid(procs))
    return (v, v)                      # Cannon's map is already the tuned one


def _summa_tuning(procs: int) -> tuple[float, float]:
    g = square_grid(procs)
    return (summa_volume(MATMUL_PROBLEM, g),
            summa_volume(MATMUL_PROBLEM, g, panel=4))


def _pumma_tuning(procs: int) -> tuple[float, float]:
    v = summa_volume(MATMUL_PROBLEM, square_grid(procs))
    return (v, v)


def _johnson_tuning(procs: int) -> tuple[float, float]:
    return (johnson_volume(MATMUL_PROBLEM, cube_grid(procs)),
            johnson_volume(MATMUL_PROBLEM, cosma_grid(MATMUL_PROBLEM, procs)))


def _solomonik_tuning(procs: int) -> tuple[float, float]:
    q = math.isqrt(procs)
    default = solomonik_volume(MATMUL_PROBLEM, (q, q, 1)) if q * q == procs \
        else solomonik_volume(MATMUL_PROBLEM, replicated_grid(procs))
    return (default, solomonik_volume(MATMUL_PROBLEM, replicated_grid(procs)))


def _cosma_tuning(procs: int) -> tuple[float, float]:
    return (johnson_volume(
                MATMUL_PROBLEM, tuple(greedy_factorization(procs, 3))),
            cosma_volume(MATMUL_PROBLEM, procs))


def _halo_volume(lengths, fields: int):
    def vol(procs: int) -> float:
        return fields * halo_surface_volume(
            lengths, optimal_factorization(procs, lengths)
        )

    return vol


def _halo_tuning(lengths, fields: int):
    def tuning(procs: int) -> tuple[float, float]:
        return (
            fields * halo_surface_volume(
                lengths, greedy_factorization(procs, 2)),
            fields * halo_surface_volume(
                lengths, optimal_factorization(procs, lengths)),
        )

    return tuning


def _circuit_volume(procs: int) -> float:
    """all_gather(V) + psum_scatter(Q): ring cost (p-1) * n each way."""
    n_nodes = CIRCUIT_NODES_PER_PIECE * procs
    return 2.0 * (procs - 1) * n_nodes


def _circuit_tuning(procs: int) -> tuple[float, float]:
    # ZCMEM placement of the shared charge removes a device round trip
    # (modeled as in the paper's Table 2 circuit row).
    v = _circuit_volume(procs)
    return (v, 0.75 * v)


# ------------------------------------------------------------- search spaces
# Candidate axes + cost objective per app for the mapper autotuner
# (repro_torch.search). The legacy ``tuning`` pairs above stay as regression
# oracles the tuner must rediscover; the search space is what it actually
# explores: grid factorizations (validity-filtered), block/cyclic
# distribution choices and transform orderings over the machine hierarchy,
# plus app-specific option axes (circuit's memory placement).


def _render_directives(*lines: str):
    def render(task: str, opts: dict[str, str]) -> str:
        return "".join(ln.format(task=task, **opts) + "\n" for ln in lines)

    return render


def _square_ok(grid: tuple[int, ...]) -> bool:
    return grid[0] == grid[1]


def _replicated_ok(grid: tuple[int, ...]) -> bool:
    q1, q2, c = grid
    return q1 == q2 and 1 <= c <= q1 and q1 % c == 0


def _solomonik_default_grid(procs: int) -> tuple[int, int, int]:
    q = math.isqrt(procs)
    if q * q == procs:
        return (q, q, 1)
    return replicated_grid(procs)


def _matmul_space(algorithm: str, *, rank: int, grid_ok=None, default_grid=None,
                  directives=None) -> SearchSpace:
    # directives=None: the renderer's standard Region/Backpressure fallback
    # (repro_torch.search.space.standard_directives) applies.
    return SearchSpace(
        rank=rank,
        cost_model=lambda procs, opts: MatmulCostModel(MATMUL_PROBLEM, algorithm),
        grid_ok=grid_ok,
        default_grid=default_grid,
        directives=directives,
    )


CANNON_SPACE = _matmul_space(
    "cannon", rank=2, grid_ok=_square_ok, default_grid=square_grid,
    directives=_render_directives(
        "Region {task} arg0 GPU FBMEM",
        "Region {task} arg1 GPU FBMEM",
        "GarbageCollect {task} arg2",
        "Backpressure {task} 1",
    ),
)
SUMMA_SPACE = _matmul_space(
    "summa", rank=2, default_grid=square_grid,
    directives=_render_directives(
        "Region {task} arg0 GPU FBMEM",
        "Region {task} arg1 GPU FBMEM",
        "Backpressure {task} 2",
    ),
)
PUMMA_SPACE = _matmul_space("pumma", rank=2, default_grid=square_grid)
JOHNSON_SPACE = _matmul_space("johnson", rank=3, default_grid=cube_grid)
SOLOMONIK_SPACE = _matmul_space(
    "solomonik", rank=3, grid_ok=_replicated_ok,
    default_grid=_solomonik_default_grid,
    directives=_render_directives(
        "Region {task} arg0 GPU FBMEM",
        "GarbageCollect {task} arg2",
        "Backpressure {task} 1",
    ),
)
COSMA_SPACE = _matmul_space(
    "cosma", rank=3, default_grid=lambda p: tuple(greedy_factorization(p, 3)),
)

CIRCUIT_SPACE = SearchSpace(
    rank=1,
    cost_model=lambda procs, opts: GatherScatterCostModel(
        CIRCUIT_NODES_PER_PIECE,
        discount=0.75 if opts.get("arg1") == "ZCMEM" else 1.0,
    ),
    option_axes=(("arg1", ("ZCMEM", "FBMEM")),),
    default_grid=lambda p: (p,),
    default_options=(("arg1", "FBMEM"),),
    directives=_render_directives(
        "Region {task} arg0 GPU FBMEM",
        "Region {task} arg1 CPU {arg1}",
        "Backpressure {task} 2",
    ),
)


def _halo_space(lengths: tuple[int, ...], fields: int) -> SearchSpace:
    return SearchSpace(
        rank=len(lengths),
        cost_model=lambda procs, opts: HaloCostModel(lengths, fields=fields),
        default_grid=lambda p: greedy_factorization(p, len(lengths)),
    )


STENCIL_SPACE = _halo_space(STENCIL_LENGTHS, 1)
PENNANT_SPACE = _halo_space(PENNANT_ZONES, PENNANT_FIELDS)


# --------------------------------------------------------- collective patterns
# Wire-level schedules for the simulator (repro_torch.sim): what one step of the
# app actually puts on the fabric, parameterized by the static problem
# constants; everything grid-dependent is derived from the mapper's
# assignment grid inside repro_torch.sim.collectives.build_phases.
_MATMUL_DIMS = {"m": MATMUL_PROBLEM.m, "n": MATMUL_PROBLEM.n,
                "k": MATMUL_PROBLEM.k}
SHIFT_PATTERN = CollectivePattern("shift", dict(_MATMUL_DIMS))
PANEL_PATTERN = CollectivePattern("panel_broadcast", dict(_MATMUL_DIMS))
BCAST3D_PATTERN = CollectivePattern("bcast_reduce_3d", dict(_MATMUL_DIMS))
# The c replication axis (axis 2) carries the 2.5D broadcast/reduce;
# expert placement keeps it on the intra-node fabric (local_axes).
SHIFT25D_PATTERN = CollectivePattern(
    "replicated_shift", {**_MATMUL_DIMS, "local_axes": (2,)},
)
CIRCUIT_PATTERN = CollectivePattern(
    "gather_scatter", {"nodes_per_piece": CIRCUIT_NODES_PER_PIECE},
)
STENCIL_PATTERN = CollectivePattern(
    "halo", {"lengths": STENCIL_LENGTHS, "fields": 1},
)
PENNANT_PATTERN = CollectivePattern(
    "halo", {"lengths": PENNANT_ZONES, "fields": PENNANT_FIELDS},
)


# -------------------------------------------------------------- registration
register(Application(
    name="cannon",
    kind=MATMUL,
    pattern="shift",
    description="Cannon's systolic matmul on a (q, q) torus",
    default_procs=4,
    axis_names=("x", "y"),
    machine_shape=_matmul_machine,
    tile_grid=square_grid,
    mapple_template=_cannon_mapple,
    comm_volume=lambda p: cannon_volume(MATMUL_PROBLEM, square_grid(p)),
    step_flops=lambda p: MATMUL_PROBLEM.flops,
    tuning=_cannon_tuning,
    search_space=CANNON_SPACE,
    collective=SHIFT_PATTERN,
    lowlevel_fixture="benchmarks/lowlevel/cannon_raw.py",
    validate="matmul",
    meta={"problem": MATMUL_PROBLEM},
))

register(Application(
    name="summa",
    kind=MATMUL,
    pattern="broadcast",
    description="SUMMA panel-broadcast matmul on a (q, q) grid",
    default_procs=4,
    axis_names=("x", "y"),
    machine_shape=_matmul_machine,
    tile_grid=square_grid,
    mapple_template=_summa_mapple,
    comm_volume=lambda p: summa_volume(MATMUL_PROBLEM, square_grid(p)),
    step_flops=lambda p: MATMUL_PROBLEM.flops,
    tuning=_summa_tuning,
    search_space=SUMMA_SPACE,
    collective=PANEL_PATTERN,
    lowlevel_fixture="benchmarks/lowlevel/summa_raw.py",
    validate="matmul",
    meta={"problem": MATMUL_PROBLEM},
))

register(Application(
    name="pumma",
    kind=MATMUL,
    pattern="broadcast",
    description="PUMMA block-cyclic panel matmul on a (q, q) grid",
    default_procs=4,
    axis_names=("x", "y"),
    machine_shape=_matmul_machine,
    tile_grid=square_grid,
    mapple_template=_pumma_mapple,
    comm_volume=lambda p: summa_volume(MATMUL_PROBLEM, square_grid(p)),
    step_flops=lambda p: MATMUL_PROBLEM.flops,
    tuning=_pumma_tuning,
    search_space=PUMMA_SPACE,
    collective=PANEL_PATTERN,
    lowlevel_fixture="benchmarks/lowlevel/pumma_raw.py",
    validate="matmul",
    meta={"problem": MATMUL_PROBLEM},
))

register(Application(
    name="johnson",
    kind=MATMUL,
    pattern="allreduce3d",
    description="Johnson's 3D matmul on a (q, q, q) cube",
    default_procs=8,
    axis_names=("x", "y", "z"),
    machine_shape=lambda p: (p, 1),
    tile_grid=cube_grid,
    mapple_template=_johnson_mapple,
    comm_volume=lambda p: johnson_volume(MATMUL_PROBLEM, cube_grid(p)),
    step_flops=lambda p: MATMUL_PROBLEM.flops,
    tuning=_johnson_tuning,
    search_space=JOHNSON_SPACE,
    collective=BCAST3D_PATTERN,
    lowlevel_fixture="benchmarks/lowlevel/johnson_raw.py",
    validate="matmul",
    meta={"problem": MATMUL_PROBLEM},
))

register(Application(
    name="solomonik",
    kind=MATMUL,
    pattern="allreduce3d",
    description="Solomonik's 2.5D matmul on a (q, q, c) grid",
    default_procs=8,
    axis_names=("x", "y", "z"),
    machine_shape=_science_machine,
    tile_grid=replicated_grid,
    mapple_template=_solomonik_mapple,
    comm_volume=lambda p: solomonik_volume(MATMUL_PROBLEM, replicated_grid(p)),
    step_flops=lambda p: MATMUL_PROBLEM.flops,
    tuning=_solomonik_tuning,
    search_space=SOLOMONIK_SPACE,
    collective=SHIFT25D_PATTERN,
    lowlevel_fixture="benchmarks/lowlevel/solomonik_raw.py",
    validate="matmul",
    meta={"problem": MATMUL_PROBLEM},
))

register(Application(
    name="cosma",
    kind=MATMUL,
    pattern="allreduce3d",
    description="COSMA communication-optimal matmul (derived grid)",
    default_procs=8,
    axis_names=("x", "y", "z"),
    machine_shape=lambda p: (p, 1),
    tile_grid=lambda p: cosma_grid(MATMUL_PROBLEM, p),
    mapple_template=_cosma_mapple,
    comm_volume=lambda p: cosma_volume(MATMUL_PROBLEM, p),
    step_flops=lambda p: MATMUL_PROBLEM.flops,
    tuning=_cosma_tuning,
    search_space=COSMA_SPACE,
    collective=BCAST3D_PATTERN,
    lowlevel_fixture="benchmarks/lowlevel/cosma_raw.py",
    validate="matmul",
    meta={"problem": MATMUL_PROBLEM},
))

register(Application(
    name="circuit",
    kind=SCIENCE,
    pattern="graph",
    description="Legion circuit simulation (gather V / scatter Q per step)",
    default_procs=8,
    axis_names=("x",),
    machine_shape=_science_machine,
    tile_grid=lambda p: (p,),
    mapple_template=_circuit_mapple,
    comm_volume=_circuit_volume,
    step_flops=lambda p: 12.0 * CIRCUIT_WIRES_PER_PIECE * p,
    tuning=_circuit_tuning,
    search_space=CIRCUIT_SPACE,
    collective=CIRCUIT_PATTERN,
    lowlevel_fixture="benchmarks/lowlevel/circuit_raw.py",
    validate="circuit",
    meta={"nodes_per_piece": CIRCUIT_NODES_PER_PIECE},
))

register(Application(
    name="stencil",
    kind=SCIENCE,
    pattern="halo",
    description="2D 5-point Jacobi stencil, decompose-partitioned",
    default_procs=8,
    axis_names=("x", "y"),
    machine_shape=_science_machine,
    tile_grid=_stencil_grid(STENCIL_LENGTHS),
    mapple_template=_stencil_mapple,
    comm_volume=_halo_volume(STENCIL_LENGTHS, 1),
    step_flops=lambda p: 5.0 * STENCIL_LENGTHS[0] * STENCIL_LENGTHS[1],
    tuning=_halo_tuning(STENCIL_LENGTHS, 1),
    search_space=STENCIL_SPACE,
    collective=STENCIL_PATTERN,
    lowlevel_fixture="benchmarks/lowlevel/stencil_raw.py",
    validate="stencil",
    meta={"lengths": STENCIL_LENGTHS, "flops_per_point": 5.0,
          "halo_fields": 1},
))

register(Application(
    name="pennant",
    kind=SCIENCE,
    pattern="halo",
    description="PENNANT staggered-grid hydro proxy (3-field halo)",
    default_procs=8,
    axis_names=("x", "y"),
    machine_shape=_science_machine,
    tile_grid=_stencil_grid(PENNANT_ZONES),
    mapple_template=_pennant_mapple,
    comm_volume=_halo_volume(PENNANT_ZONES, PENNANT_FIELDS),
    step_flops=lambda p: 20.0 * PENNANT_ZONES[0] * PENNANT_ZONES[1],
    tuning=_halo_tuning(PENNANT_ZONES, PENNANT_FIELDS),
    search_space=PENNANT_SPACE,
    collective=PENNANT_PATTERN,
    lowlevel_fixture="benchmarks/lowlevel/pennant_raw.py",
    validate="pennant",
    meta={"lengths": PENNANT_ZONES, "flops_per_point": 20.0,
          "halo_fields": PENNANT_FIELDS},
))

PAPER_APPS = (
    "cannon", "summa", "pumma", "johnson", "solomonik", "cosma",
    "circuit", "stencil", "pennant",
)
