"""Single-process SPMD substrate: a mesh of virtual ranks on one device.

The counterpart of ``repro.core.jaxcompat.shard_map``. Every virtual
rank's block is a slice of ONE tensor whose leading dims are the mesh
dims (the *stacked* form, ``(*mesh.shape, *block)``), so

  * a body runs once for all ranks and each local kernel serves every
    rank in one launch (the rank dims are the kernel's batch);
  * collectives are on-device indexing and sums over the stacked dims;
  * a mesh axis an operand is not partitioned over is a broadcast dim
    (``expand``: every rank along it sees the same block, no copy).

Bodies address block dims with negative indices (or, in the collectives
below, with block-relative non-negative dims as JAX does); the collectives
map axis names to stacked dims through the context :func:`shard_map` sets
while the body runs.

A partition-spec entry may name several mesh axes, ``P(("pod", "data"),
"model")``: that tensor dim splits over all of them, the first the major,
as in JAX. A mesh is *in scope* inside ``with use_mesh(mesh):`` (the
counterpart of the reference's ``with mesh:``, read by
:func:`current_mesh`); that is apart from the mesh a running body sees.
:func:`count` tallies the collectives and the mesh paths that call it,
so a test can tell that a mesh path really ran.

The mesh records which virtual device id sits at each mesh coordinate
(``device_ids = device_permutation.reshape(tile_grid)``): the Mapple
mapper's decision. Numerics never depend on it, exactly as a JAX mesh's
device order does not change what a shard_map program computes;
:func:`placement` reads it back as ``{virtual device id: block}``.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Virtual device ids laid out on named axes, on one torch device."""

    device_ids: np.ndarray                 # int, shape == tile grid
    axis_names: tuple[str, ...]
    device: torch.device

    def __post_init__(self) -> None:
        ids = np.asarray(self.device_ids, dtype=np.int64)
        if ids.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of rank {ids.ndim} needs {ids.ndim} axis names, got "
                f"{self.axis_names}"
            )
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axis names: {self.axis_names}")
        object.__setattr__(self, "device_ids", ids)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(int(s) for s in self.device_ids.shape)

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    def axis(self, name: str) -> int:
        """Position of a named axis among the mesh (= leading stacked) dims."""
        try:
            return self.axis_names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown mesh axis {name!r}; mesh axes: {self.axis_names}"
            ) from None

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis(name)]


class P(tuple):
    """Partition spec: per global tensor dim, one mesh axis name, a tuple
    of names (the dim splits over all of them, major to minor), or None.
    A tuple of one name is that name, and an empty one None, as in JAX."""

    def __new__(cls, *axes):
        entries = []
        for a in axes:
            names = a if isinstance(a, tuple) else (a,)
            if a is not None and not all(isinstance(n, str) for n in names):
                raise TypeError(
                    f"partition spec entries are axis names, tuples of axis "
                    f"names or None, got {a!r}"
                )
            if isinstance(a, tuple) and len(a) < 2:
                a = a[0] if a else None
            entries.append(a)
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


def _names(entry) -> tuple[str, ...]:
    """The mesh axes a spec entry splits its dim over, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


_COUNTS: collections.Counter = collections.Counter()


def count(name: str) -> None:
    """Add one to ``name``'s tally (a collective or a mesh path)."""
    _COUNTS[name] += 1


def counts() -> dict[str, int]:
    return dict(_COUNTS)


def reset_counts() -> None:
    _COUNTS.clear()


_SCOPE: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "spmd_scope", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Put ``mesh`` in scope (None: no mesh) for the block: the reference's
    ``with mesh:``. The model code reads it through :func:`current_mesh`."""
    token = _SCOPE.set(mesh)
    try:
        yield mesh
    finally:
        _SCOPE.reset(token)


def current_mesh() -> Mesh | None:
    """The mesh in scope, or None."""
    return _SCOPE.get()


_MESH: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "spmd_mesh", default=None)


@contextlib.contextmanager
def _active(mesh: Mesh):
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def _mesh() -> Mesh:
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("SPMD collectives are valid only inside a "
                           "shard_map body")
    return mesh


def _spec_for(spec: Sequence, ndim: int, mesh: Mesh) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    spec = spec + (None,) * (ndim - len(spec))
    named = [a for e in spec for a in _names(e)]
    if len(set(named)) != len(named):
        raise ValueError(f"spec {spec} partitions over one axis twice")
    for a in named:
        mesh.axis(a)
    return spec


def split(x: torch.Tensor, spec: Sequence, mesh: Mesh) -> torch.Tensor:
    """Global tensor -> stacked ``(*mesh.shape, *block)`` view.

    Dim ``d`` partitioned over axis ``a`` is cut into ``mesh.axis_size(a)``
    equal blocks, block ``i`` going to mesh coordinate ``i`` along ``a``
    (JAX's rule); over axes ``(a, b)`` it is cut into ``|a| * |b|`` blocks,
    block ``i * |b| + j`` going to coordinate ``(i, j)``. Axes the spec does
    not name are broadcast (``expand``).
    """
    spec = _spec_for(spec, x.ndim, mesh)
    shape: list[int] = []
    mesh_dim = {}                          # axis name -> dim in `shape`
    block_dims = []
    for d, e in enumerate(spec):
        n = int(x.shape[d])
        names = _names(e)
        g = int(np.prod([mesh.axis_size(a) for a in names], dtype=np.int64))
        if n % g:
            raise ValueError(
                f"dim {d} of size {n} does not split evenly over mesh "
                f"axes {names} of size {g}"
            )
        for a in names:
            mesh_dim[a] = len(shape)
            shape.append(mesh.axis_size(a))
        shape.append(n // g)
        block_dims.append(len(shape) - 1)
    y = x.reshape(shape)
    present = [a for a in mesh.axis_names if a in mesh_dim]
    y = y.permute(*[mesh_dim[a] for a in present], *block_dims)
    for i, a in enumerate(mesh.axis_names):
        if a not in mesh_dim:
            y = y.unsqueeze(i)
    return y.expand(*mesh.shape, *y.shape[mesh.ndim:])


def assemble(y: torch.Tensor, spec: Sequence, mesh: Mesh) -> torch.Tensor:
    """Stacked ``(*mesh.shape, *block)`` -> global tensor (inverse of split).

    Mesh axes the spec does not name must hold replicas; coordinate 0 is
    taken (JAX's shard_map without replication checks does the same).
    """
    if tuple(y.shape[:mesh.ndim]) != mesh.shape:
        raise ValueError(f"stacked output of shape {tuple(y.shape)} does not "
                         f"lead with the mesh shape {mesh.shape}")
    nblock = y.ndim - mesh.ndim
    spec = _spec_for(spec, nblock, mesh)
    named = {a for e in spec for a in _names(e)}
    keep = [a for a in mesh.axis_names if a in named]
    index = tuple(slice(None) if a in named else 0 for a in mesh.axis_names)
    y = y[index]                           # (*kept mesh dims, *block)
    order, shape = [], []
    for d, e in enumerate(spec):
        b = len(keep) + d
        n = y.shape[b]
        for a in _names(e):
            order.append(keep.index(a))
            n *= y.shape[keep.index(a)]
        order.append(b)
        shape.append(n)
    return y.permute(order).reshape(shape)


def shard_map(body: Callable[..., Any], mesh: Mesh, in_specs: Sequence[P],
              out_specs: Any) -> Callable[..., Any]:
    """Run ``body`` once over the stacked blocks of every rank.

    ``in_specs`` has one spec per positional argument; ``out_specs`` is a
    spec or a tuple of specs matching the body's output. Arguments are
    moved to the mesh's device first, so the body runs where the mesh is.
    """
    in_specs = tuple(in_specs)

    def fn(*args: torch.Tensor):
        if len(args) != len(in_specs):
            raise TypeError(f"body takes {len(in_specs)} sharded arguments, "
                            f"got {len(args)}")
        count("shard_map")
        stacked = [split(x.to(mesh.device), s, mesh)
                   for x, s in zip(args, in_specs)]
        with _active(mesh):
            out = body(*stacked)
        if isinstance(out_specs, P):
            return assemble(out, out_specs, mesh)
        if len(out) != len(out_specs):
            raise ValueError(f"body returned {len(out)} outputs for "
                             f"{len(out_specs)} out_specs")
        return type(out)(assemble(o, s, mesh) for o, s in zip(out, out_specs))

    return fn


def placement(mesh: Mesh, stacked: torch.Tensor) -> dict[int, torch.Tensor]:
    """``{virtual device id: block}``: where the mapper put each tile."""
    if tuple(stacked.shape[:mesh.ndim]) != mesh.shape:
        raise ValueError(f"stacked tensor of shape {tuple(stacked.shape)} "
                         f"does not lead with the mesh shape {mesh.shape}")
    return {
        int(mesh.device_ids[idx]): stacked[idx]
        for idx in np.ndindex(*mesh.shape)
    }


# ------------------------------------------------------------- collectives
def _block_dim(x: torch.Tensor, mesh: Mesh, dim: int) -> int:
    """Block-relative (>= 0, as in JAX) or negative dim -> stacked dim."""
    nblock = x.ndim - mesh.ndim
    if not -nblock <= dim < nblock:
        raise IndexError(f"block dim {dim} out of range for {nblock} block "
                         f"dims")
    return mesh.ndim + dim if dim >= 0 else x.ndim + dim


def _axes(axis: str | Sequence[str]) -> list[int]:
    """Mesh dims of one axis name or a tuple of them."""
    mesh = _mesh()
    return [mesh.axis(a) for a in ((axis,) if isinstance(axis, str) else axis)]


def axis_index(axis: str) -> torch.Tensor:
    """Each rank's coordinate along ``axis``, shaped to broadcast over the
    mesh dims (size 1 on every other axis). Combine it with the stacked
    blocks through :func:`where`."""
    mesh = _mesh()
    a = mesh.axis(axis)
    shape = [1] * mesh.ndim
    shape[a] = mesh.shape[a]
    return torch.arange(mesh.shape[a], device=mesh.device).reshape(shape)


def where(cond: torch.Tensor | bool, x: torch.Tensor, y: torch.Tensor
          ) -> torch.Tensor:
    """``torch.where`` with a per-rank condition over the mesh dims (as built
    from :func:`axis_index`), broadcast across the block dims."""
    if isinstance(cond, torch.Tensor):
        cond = cond.reshape(*cond.shape,
                            *[1] * (max(x.ndim, y.ndim) - cond.ndim))
    return torch.where(cond, x, y)


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Rank ``src`` sends its block to ``dst`` along ``axis`` for every
    ``(src, dst)`` pair; a rank that receives nothing gets zeros."""
    count("ppermute")
    mesh = _mesh()
    a = mesh.axis(axis)
    n = mesh.shape[a]
    src_of = [-1] * n
    for src, dst in perm:
        if not (0 <= src < n and 0 <= dst < n) or src_of[dst] != -1:
            raise ValueError(f"invalid permutation {perm} for axis {axis!r} "
                             f"of size {n}")
        src_of[dst] = src
    if -1 not in src_of:
        idx = torch.tensor(src_of, device=x.device)
        return x.index_select(a, idx)
    idx = torch.tensor([max(s, 0) for s in src_of], device=x.device)
    got = torch.tensor([s >= 0 for s in src_of], device=x.device)
    shape = [1] * x.ndim
    shape[a] = n
    return torch.where(got.reshape(shape), x.index_select(a, idx),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def psum(x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
    """Sum over the ranks along ``axis`` (a name or a tuple of names);
    every rank holds the total."""
    count("psum")
    dims = _axes(axis)
    return x.sum(dim=dims, keepdim=True).expand(x.shape)


def pmax(x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
    """Largest value over the ranks along ``axis``; every rank holds it."""
    count("pmax")
    dims = _axes(axis)
    return x.amax(dim=dims, keepdim=True).expand(x.shape)


def all_gather(x: torch.Tensor, axis: str, *, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Concatenate the ranks' blocks along block dim ``dim``; every rank
    along ``axis`` holds the result."""
    if not tiled:
        raise NotImplementedError("only tiled all_gather is supported")
    count("all_gather")
    mesh = _mesh()
    a = mesh.axis(axis)
    d = _block_dim(x, mesh, dim)
    g = x.shape[a]
    y = x.movedim(a, d - 1)                # rank dim just before the block dim
    shape = list(y.shape)
    shape[d - 1:d + 1] = [g * shape[d]]
    y = y.reshape(shape).unsqueeze(a)
    return y.expand(*y.shape[:a], g, *y.shape[a + 1:])


def psum_scatter(x: torch.Tensor, axis: str, scatter_dimension: int = 0,
                 *, tiled: bool = True) -> torch.Tensor:
    """Sum over the ranks along ``axis``, then rank ``i`` keeps the ``i``-th
    of ``axis_size`` equal chunks of block dim ``scatter_dimension``."""
    if not tiled:
        raise NotImplementedError("only tiled psum_scatter is supported")
    count("psum_scatter")
    mesh = _mesh()
    a = mesh.axis(axis)
    d = _block_dim(x, mesh, scatter_dimension)
    g = x.shape[a]
    n = x.shape[d]
    if n % g:
        raise ValueError(f"block dim of size {n} does not scatter evenly "
                         f"over {g} ranks")
    s = x.sum(dim=a)                       # the rank dim is gone: d -> d - 1
    shape = list(s.shape)
    shape[d - 1:d] = [g, n // g]
    return s.reshape(shape).movedim(d - 1, a)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int, concat_axis: int,
               *, tiled: bool = False) -> torch.Tensor:
    """Rank ``i`` along ``axis`` sends the ``j``-th slice of block dim
    ``split_axis`` (whose size is the axis size) to rank ``j``, which
    stacks what it receives, by sender, on a new block dim at
    ``concat_axis`` (JAX's ``tiled=False``: the split dim goes, the
    sender dim comes). In the stacked form that is a swap of the mesh dim
    with the split dim, then a move: a view, no copy."""
    if tiled:
        raise NotImplementedError("only all_to_all with tiled=False is "
                                  "supported")
    count("all_to_all")
    mesh = _mesh()
    a = mesh.axis(axis)
    s = _block_dim(x, mesh, split_axis)
    if x.shape[s] != mesh.shape[a]:
        raise ValueError(f"split dim of size {x.shape[s]} is not the size "
                         f"{mesh.shape[a]} of axis {axis!r}")
    nblock = x.ndim - mesh.ndim
    if not -nblock <= concat_axis < nblock:
        raise IndexError(f"concat dim {concat_axis} out of range for "
                         f"{nblock} block dims")
    c = mesh.ndim + (concat_axis % nblock)
    return x.transpose(a, s).movedim(s, c)
