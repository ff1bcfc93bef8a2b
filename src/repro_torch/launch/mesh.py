"""Production meshes of virtual ranks (a FUNCTION — importing this builds
nothing).

The port of ``repro.launch.mesh``, on the single-process substrate
(``core/spmd.py``): a mesh is virtual device ids laid out on named axes,
all on one torch device.

Single pod: 256 virtual ranks as (data=16, model=16).
Multi-pod:  2 pods x 256 virtual ranks as (pod=2, data=16, model=16).

The device ORDER inside the mesh is a Mapple decision: by default the
identity (block) order; ``mapper_permutation`` gives a Mapple mapper's
tile->device map (Sec. 5 translation), applied before reshaping, which is
how the hillclimb experiments reorder collectives without touching model
code. The ids are the reference's device ids at the same positions.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.spmd import Mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence[int] | None = None,
                         permutation: Sequence[int] | None = None,
                         device="cuda") -> Mesh:
    """``devices``: the virtual ids to lay out (default ``0..n-1``; the
    first n are taken); ``permutation`` reorders them before the reshape;
    ``device``: the torch device every rank's block lives on."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    ids = np.arange(n) if devices is None else np.asarray(devices, dtype=np.int64)
    if ids.size < n:
        raise RuntimeError(f"mesh {shape} needs {n} device ids, have {ids.size}")
    ids = ids[:n]
    if permutation is not None:
        ids = ids[np.asarray(permutation, dtype=np.int64)]
    return Mesh(ids.reshape(shape), axes, device)


def mapper_permutation(mapper, grid_shape: Sequence[int]) -> np.ndarray:
    """Evaluate a Mapple mapper into a flat device permutation."""
    n = int(np.prod(tuple(grid_shape)))
    return mapper.tile_permutation(tuple(grid_shape), n)


def small_mesh(axis_names=("data", "model"), shape=None, device="cuda") -> Mesh:
    """A mesh of ``shape`` virtual ranks (tests, examples); (1, 1), one
    rank, when no shape is given, as the reference's is over the one
    device a card process has."""
    if shape is None:
        shape = (1,) * len(axis_names)
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axis_names, device)
