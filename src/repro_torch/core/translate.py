"""Translation layer: Mapple mappers -> SPMD plans on a mesh of virtual ranks.

The counterpart of ``repro.core.translate``. The mapping function is
evaluated over the whole tile grid once and the resulting tile->device
permutation is baked into the :class:`~repro_torch.core.spmd.Mesh`
(``device_ids = permutation.reshape(tile_grid)``); block ``i`` of a
sharded axis goes to mesh coordinate ``i``, so any bijective Mapple
tile->processor map is realised by the permuted device ids. The ranks
are virtual and share one torch device, so a plan's mesh always exists,
whatever the processor count.

The remaining Mapple directives translate to:

  Region      -> :class:`Sharding` memory kind: ``device`` tensors on the
                 mesh's device, ``pinned_host`` tensors in pinned CPU memory
  Layout      -> operand dim-order hints (:class:`LayoutSpec`)
  GarbageCollect -> the plan's ``donate`` set
  Backpressure   -> the plan's bounded in-flight step depth
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.machine import FBMEM, SYSMEM, ZCMEM
from repro_torch.core.mapper import Mapper
from repro_torch.core.spmd import Mesh, P, split


@dataclasses.dataclass(frozen=True)
class LayoutSpec:
    """The paper's Layout directive: ordering + alignment per operand."""

    order: str = "C"          # "C" (row-major) | "F" (column-major)
    alignment: int = 128      # bytes
    soa: bool = True          # Struct-of-Arrays preferred


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where an operand's stacked blocks live: a mesh, a spec, a memory kind."""

    mesh: Mesh
    spec: P
    memory_kind: str = FBMEM

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """Global tensor -> its stacked blocks in this sharding's memory.

        ``device`` blocks live on the mesh's device. ``pinned_host`` blocks
        are a pinned CPU tensor when the mesh is on a card (pinning is a
        property of host memory seen by a card; for a CPU mesh they are
        plain host tensors), ``unpinned_host`` blocks plain host tensors.
        """
        if self.memory_kind not in (FBMEM, ZCMEM, SYSMEM):
            raise ValueError(f"unknown memory kind {self.memory_kind!r}")
        if self.memory_kind == FBMEM:
            return split(x.to(self.mesh.device), self.spec, self.mesh)
        blocks = split(x.cpu(), self.spec, self.mesh).contiguous()
        if self.memory_kind == ZCMEM and self.mesh.device.type == "cuda":
            return blocks.pin_memory()
        return blocks


@dataclasses.dataclass
class MappingPlan:
    """Everything the launcher needs to execute a step under a mapper."""

    mesh: Mesh
    axis_names: tuple[str, ...]
    in_specs: dict[str, P]                       # operand -> partition spec
    out_specs: dict[str, P]
    memory_kinds: dict[str, str] = dataclasses.field(default_factory=dict)
    layouts: dict[str, LayoutSpec] = dataclasses.field(default_factory=dict)
    donate: tuple[str, ...] = ()
    backpressure: int = 2                        # max in-flight steps
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def sharding(self, operand: str) -> Sharding:
        """The operand's :class:`Sharding`, honoring its Region memory kind."""
        spec = self.in_specs.get(operand) or self.out_specs.get(operand)
        if spec is None:
            raise KeyError(f"plan has no operand {operand!r}")
        return Sharding(self.mesh, spec, self.memory_kinds.get(operand, FBMEM))


def device_permutation(mapper: Mapper, tile_grid: Sequence[int], nprocs: int
                       ) -> np.ndarray:
    """Flat tile order -> device id (bijective), from the mapping function."""
    return mapper.tile_permutation(tile_grid, nprocs)


def mesh_from_mapper(
    mapper: Mapper,
    tile_grid: Sequence[int],
    axis_names: Sequence[str],
    device: torch.device | str = "cuda",
) -> Mesh:
    """Build a Mesh whose device ids realise ``mapper`` over ``tile_grid``."""
    tile_grid = tuple(int(t) for t in tile_grid)
    n = int(np.prod(tile_grid))
    perm = device_permutation(mapper, tile_grid, n)
    return Mesh(np.asarray(perm).reshape(tile_grid), tuple(axis_names), device)


def owned_tiles(mapper: Mapper, ispace: Sequence[int], nprocs: int
                ) -> dict[int, list[tuple[int, ...]]]:
    """Many-to-one case: tiles owned by each device (cyclic distributions).

    Consumes the cached vectorized assignment grid and groups points with
    one stable argsort (per-device point order stays row-major).
    """
    grid = mapper.assignment_grid(ispace)
    flat = grid.reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= nprocs):
        raise ValueError(
            f"mapper {mapper.name} assigns device ids outside [0, {nprocs})"
        )
    order = np.argsort(flat, kind="stable")
    pts = np.stack(np.unravel_index(order, grid.shape), axis=1)
    bounds = np.searchsorted(flat[order], np.arange(nprocs + 1))
    return {
        d: [tuple(int(x) for x in row) for row in pts[bounds[d]:bounds[d + 1]]]
        for d in range(nprocs)
    }


#: Mapple directives don't distinguish inputs from outputs, so the default
#: operand-spec derivation uses a NAMING CONVENTION: exactly ``out`` or
#: ``out<digits>`` is an output operand; everything else is an input.
_OUT_OPERAND = re.compile(r"^out\d*$")


def is_output_operand(name: str) -> bool:
    return _OUT_OPERAND.fullmatch(name) is not None


def declared_operands(program, task: str) -> tuple[str, ...]:
    """Operand names a task's Region/Layout/GarbageCollect directives declare."""
    names = (
        {arg for (t, arg) in program.regions if t == task}
        | {arg for (t, arg) in program.layouts if t == task}
        | {arg for (t, arg) in program.garbage_collect if t == task}
    )
    return tuple(sorted(names))


def to_spmd(
    program,                      # repro_torch.core.dsl.MapperProgram
    task: str,
    tile_grid: Sequence[int],
    axis_names: Sequence[str],
    operand_specs: Mapping[str, P] | None = None,
    out_operand_specs: Mapping[str, P] | None = None,
    device: torch.device | str = "cuda",
) -> MappingPlan:
    """End-to-end translation entry point: parsed Mapple program -> SPMD plan.

    The mapping function is evaluated over the whole tile grid and checked
    to be a bijection; the permutation is kept in
    ``meta['device_permutation']`` and realised as the plan's mesh on
    ``device``.
    """
    mapper_name = program.index_task_maps.get(task)
    if mapper_name is None:
        raise KeyError(f"no IndexTaskMap for task {task!r}")
    mapper = program.mappers[mapper_name]
    tile_grid = tuple(int(t) for t in tile_grid)
    n = int(np.prod(tile_grid))
    perm = device_permutation(mapper, tile_grid, n)
    mesh = Mesh(np.asarray(perm).reshape(tile_grid), tuple(axis_names), device)

    if operand_specs is None or out_operand_specs is None:
        default_spec = P(*axis_names)
        declared = declared_operands(program, task)
        if operand_specs is None:
            names = tuple(a for a in declared if not is_output_operand(a))
            operand_specs = {arg: default_spec for arg in names or ("arg0", "arg1")}
        if out_operand_specs is None:
            outs = tuple(a for a in declared if is_output_operand(a)) or ("out",)
            out_operand_specs = {arg: default_spec for arg in outs}

    memory_kinds = {
        arg: mem for (t, arg), (_, mem) in program.regions.items() if t == task
    }
    layouts = {
        arg: spec for (t, arg), spec in program.layouts.items() if t == task
    }
    donate = tuple(arg for (t, arg) in program.garbage_collect if t == task)
    return MappingPlan(
        mesh=mesh,
        axis_names=tuple(axis_names),
        in_specs=dict(operand_specs),
        out_specs=dict(out_operand_specs),
        memory_kinds=memory_kinds,
        layouts=layouts,
        donate=donate,
        backpressure=program.backpressure.get(task, 2),
        meta={
            "mapper": mapper_name,
            "task": task,
            "tile_grid": tile_grid,
            "nprocs": n,
            "device_permutation": perm,
            "mapper_ir": mapper.describe(),
        },
    )
