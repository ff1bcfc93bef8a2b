"""Unified application registry for the nine paper workloads.

The paper evaluates Mapple on six distributed matmul algorithms (Cannon,
SUMMA, PUMMA, Johnson, Solomonik, COSMA) and three scientific applications
(circuit, 2D stencil, PENNANT). This module gives every one of them the
same declarative shape — an :class:`Application` — and a single registry
through which each is parsed, mapped, translated and costed:

    dsl.parse(app.mapple_source(procs))        # the Mapple mapper program
      -> program.mappers[...]                  # Mapper object
      -> translate.to_spmd(program, ...)       # device permutation / Mesh
      -> app.comm_volume(procs)                # closed-form volume model

The end-to-end runner (`python -m repro_torch.apps.run`) and
`chip_smoke.py` iterate this registry instead of hard-coding app lists;
new workloads plug in by calling :func:`register`.

The counterpart of ``repro.apps.registry``. Only the execution hooks in
``repro_torch.apps.validate`` touch tensors.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Callable, Iterator

from repro_torch.core import dsl
from repro_torch.core.dsl import MapperProgram
from repro_torch.core.machine import GPU, Machine
from repro_torch.core.mapper import Mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.translate import MappingPlan, to_spmd
from repro_torch.search.space import SearchSpace
from repro_torch.sim.collectives import CollectivePattern

REPO_ROOT = Path(__file__).resolve().parents[3]

MATMUL = "matmul"
SCIENCE = "science"


@dataclasses.dataclass(frozen=True)
class Application:
    """One paper workload, described declaratively.

    The callables take a processor count so the same description scales
    from the paper's 2x4-GPU running example to full pods; each may raise
    ``ValueError`` for processor counts the algorithm cannot use (e.g.
    Cannon needs a square count).
    """

    name: str
    kind: str                                   # MATMUL | SCIENCE
    pattern: str                                # dominant comm pattern
    description: str
    default_procs: int
    axis_names: tuple[str, ...]
    machine_shape: Callable[[int], tuple[int, ...]]
    tile_grid: Callable[[int], tuple[int, ...]]
    mapple_template: Callable[[int], str]       # procs -> Mapple source
    comm_volume: Callable[[int], float]         # elements moved per step
    step_flops: Callable[[int], float]          # modeled compute per step
    # (default-mapper volume, tuned-mapper volume) — the Table 2 pair, kept
    # as a REGRESSION ORACLE: the autotuner must rediscover (or beat) the
    # tuned volume; tests assert it, nothing trusts it as ground truth.
    tuning: Callable[[int], tuple[float, float]] | None = None
    # Candidate axes + cost model for the mapper autotuner (repro_torch.search).
    search_space: SearchSpace | None = None
    # The wire-level communication pattern the app's step emits, consumed
    # by the discrete-event simulator (repro_torch.sim) to price a mapping in
    # seconds against the exact tile->processor assignment.
    collective: CollectivePattern | None = None
    lowlevel_fixture: str = ""                  # repo-relative baseline path
    validate: str | None = None                 # hook in repro_torch.apps.validate
    meta: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------ pipeline
    def machine(self, procs: int | None = None) -> ProcSpace:
        return Machine(GPU, shape=self.machine_shape(self.procs(procs)))

    def procs(self, procs: int | None = None) -> int:
        return self.default_procs if procs is None else int(procs)

    def mapple_source(self, procs: int | None = None) -> str:
        return self.mapple_template(self.procs(procs))

    def program(self, procs: int | None = None) -> MapperProgram:
        n = self.procs(procs)
        shape = self.machine_shape(n)
        return dsl.parse(
            self.mapple_source(n),
            machine_factory=lambda *a, **k: Machine(GPU, shape=shape),
        )

    def mapper(self, procs: int | None = None) -> Mapper:
        prog = self.program(procs)
        name = prog.index_task_maps[self.name]
        return prog.mappers[name]

    def spmd_plan(self, procs: int | None = None, device="cuda") -> MappingPlan:
        """parse -> map -> translate, returning the full SPMD plan."""
        n = self.procs(procs)
        return to_spmd(
            self.program(n),
            self.name,
            self.tile_grid(n),
            self.axis_names,
            device=device,
        )

    # ------------------------------------------------------------- metrics
    def mapple_loc(self, procs: int | None = None) -> int:
        return self.program(procs).loc()

    def lowlevel_path(self) -> Path:
        p = REPO_ROOT / self.lowlevel_fixture
        if not p.exists():
            # Installed (site-packages) layout: fall back to a repo checkout
            # in the working directory.
            cwd_p = Path.cwd() / self.lowlevel_fixture
            if cwd_p.exists():
                return cwd_p
        return p

    def lowlevel_loc(self) -> int:
        """LoC of the raw baseline; 0 when the fixture isn't available
        (e.g. running from an installed package without the repo)."""
        p = self.lowlevel_path()
        return count_python_loc(p) if p.exists() else 0


_REGISTRY: dict[str, Application] = {}


def register(app: Application) -> Application:
    if app.name in _REGISTRY:
        raise ValueError(f"application {app.name!r} already registered")
    _REGISTRY[app.name] = app
    return app


def get(name: str) -> Application:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown application {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> list[str]:
    return list(_REGISTRY)


def iter_apps(kind: str | None = None, pattern: str | None = None
              ) -> Iterator[Application]:
    for app in _REGISTRY.values():
        if kind is not None and app.kind != kind:
            continue
        if pattern is not None and app.pattern != pattern:
            continue
        yield app


# ----------------------------------------------------------------- LoC metric
def count_python_loc(path: Path) -> int:
    """Non-blank, non-comment, non-docstring lines (paper Table 1 metric)."""
    out = 0
    in_docstring = False
    for raw in path.read_text().splitlines():
        ln = raw.strip()
        if not ln:
            continue
        if ln.startswith('"""') or ln.endswith('"""'):
            if ln.count('"""') == 1:
                in_docstring = not in_docstring
            continue
        if in_docstring or ln.startswith("#"):
            continue
        out += 1
    return out


# ---------------------------------------------------------------- grid maths
def square_grid(procs: int) -> tuple[int, int]:
    q = math.isqrt(procs)
    if q * q != procs:
        raise ValueError(f"needs a square processor count, got {procs}")
    return (q, q)


def cube_grid(procs: int) -> tuple[int, int, int]:
    q = round(procs ** (1.0 / 3.0))
    if q ** 3 != procs:
        raise ValueError(f"needs a cubic processor count, got {procs}")
    return (q, q, q)


def replicated_grid(procs: int) -> tuple[int, int, int]:
    """Solomonik (q, q, c): prefer the most-replicated valid c <= q."""
    best: tuple[int, int, int] | None = None
    for c in range(1, procs + 1):
        if procs % c != 0:
            continue
        q = math.isqrt(procs // c)
        if q * q * c == procs and c <= q and q % c == 0:
            best = (q, q, c)
    if best is None:
        raise ValueError(f"cannot form a (q, q, c) grid from {procs} devices")
    return best


def two_level_machine(procs: int, gpus_per_node: int = 4) -> tuple[int, int]:
    """(nodes, gpus) factorization of a flat processor count."""
    g = gpus_per_node
    while g > 1 and procs % g:
        g //= 2
    return (max(procs // g, 1), g)
