"""Shared machinery for the six distributed matmul algorithms (paper Sec. 6).

Every algorithm is a ``shard_map`` program over a Mesh whose *device order
is produced by a Mapple mapper* (see repro_torch.core.translate). The
algorithms differ in (a) the processor grid the mapper produces and (b)
the collective schedule of the body: the mapper is the swappable part.

Bodies see stacked blocks ``(*mesh.shape, rows, cols)`` (see
``repro_torch.core.spmd``), so every local product is one batched kernel
launch over all virtual ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core import spmd
from repro_torch.core.mapper import Mapper
from repro_torch.core.spmd import Mesh, P
from repro_torch.core.translate import mesh_from_mapper
from repro_torch.kernels import ref


@dataclasses.dataclass(frozen=True)
class MatmulGrid:
    """A processor grid + the mesh realizing a Mapple mapper on it."""

    mesh: Mesh
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return self.mesh.shape


def build_grid(
    mapper: Mapper,
    grid_shape: Sequence[int],
    axis_names: Sequence[str],
    device: torch.device | str = "cuda",
) -> MatmulGrid:
    mesh = mesh_from_mapper(mapper, grid_shape, axis_names, device)
    return MatmulGrid(mesh=mesh, axis_names=tuple(axis_names))


def shift(x: torch.Tensor, axis_name: str, offset: int, axis_size: int
          ) -> torch.Tensor:
    """Cyclic shift of blocks along a mesh axis (Cannon's systolic move)."""
    perm = [(i, (i + offset) % axis_size) for i in range(axis_size)]
    return spmd.ppermute(x, axis_name, perm)


def skew(x: torch.Tensor, by_axis: str, along_axis: str,
         sizes: tuple[int, int], sign: int) -> torch.Tensor:
    """Cannon's initial alignment: block (i, j) -> (i, j - sign*i) etc.

    ``by_axis`` provides the row index i; blocks move ``sign * i`` steps
    along ``along_axis``. The distance differs per rank, so it runs as
    (n-1) single-step shifts with a per-rank predicated copy (``i`` is a
    tensor over the ``by_axis`` mesh dim).
    """
    i = spmd.axis_index(by_axis)
    n = sizes[1]
    for step in range(n - 1):
        moved = shift(x, along_axis, sign, n)
        x = spmd.where(i <= step, x, moved)
    return x


def make_inputs(m: int, k: int, n: int, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard-normal A (m, k) and B (k, n), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=device).to(dtype)
    return a, b


def local_matmul(a: torch.Tensor, b: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
    """Local block product of every rank, the per-device compute hot spot.

    With ``use_kernel=True`` routes through the Hopper matmul kernel
    (repro_torch.kernels.ops.matmul: output in A's dtype); otherwise a
    plain fp32 ``torch.matmul``.
    """
    if use_kernel:
        from repro_torch.kernels import ops

        return ops.matmul(a, b)
    ref.no_tf32()
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def sharded_matmul_wrapper(
    grid: MatmulGrid,
    body: Callable[..., torch.Tensor],
    in_specs: tuple[P, ...],
    out_spec: P,
):
    """Wrap an algorithm body in shard_map over the grid's mesh."""
    return spmd.shard_map(body, grid.mesh, in_specs, out_spec)
