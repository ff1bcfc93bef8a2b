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

*The process-group backend.* A mesh that carries a
``torch.distributed.device_mesh.DeviceMesh`` of its shape (``Mesh.dist``,
built by ``core/world.py``; its ranks are mesh positions) runs one rank
per process, or rank (0, ..., 0) alone on a fake group. There a body sees
THIS rank's block only, with no leading mesh dims (:func:`lead_dims` is
0): :func:`shard_map` takes each DTensor argument's local block (after a
redistribution if its placements differ from the spec), runs the body
once, and wraps the outputs back into DTensors at ``out_specs``; the
collectives are ``torch.distributed._functional_collectives`` over
``(device_mesh, mesh dim)``, each with its dual in the backward.
Bodies address block dims from the right (or block-relative, as JAX
does), so one body serves both backends. Where the group's backend does
not carry a collective for the blocks' device (gloo with CUDA blocks),
the world's groups stage it (``core/world.py``). Gradients follow JAX's transpose of shard_map: a block
replicated over a mesh axis its spec does not name gets the sum of the
replicas' gradients, and an output replicated so gives each replica
its share of the cotangent.
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
    """Virtual device ids laid out on named axes, on one torch device.

    ``dist``: a ``DeviceMesh`` of the same shape (``core/world.py``), or
    None for virtual ranks; ``device`` is then where this rank's blocks
    live. ``fold``: consecutive axes that are one dim of ``dist`` (major
    first), which a spec or a collective names only all together."""

    device_ids: np.ndarray                 # int, shape == tile grid
    axis_names: tuple[str, ...]
    device: torch.device
    dist: Any = None
    fold: tuple[str, ...] = ()

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
        fold = tuple(self.fold)
        if fold and (len(fold) < 2 or not all(
                self.axis(b) == self.axis(a) + 1 for a, b in zip(fold, fold[1:]))):
            raise ValueError(f"fold {fold} is not two or more consecutive axes of "
                             f"{self.axis_names}")
        object.__setattr__(self, "fold", fold)

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

    def dist_axes(self) -> list[tuple[str, ...]]:
        """The mesh axes of each ``dist`` dim, in order."""
        return [self.fold if a in self.fold else (a,) for a in self.axis_names
                if a not in self.fold[1:]]

    def dist_dims(self, axes: str | Sequence[str]) -> list[int]:
        """The ``dist`` dims of an axis name or a tuple of them; the folded
        axes count only all together."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            self.axis(a)
        out = []
        for i, group in enumerate(self.dist_axes()):
            hit = tuple(a for a in names if a in group)
            if hit and hit != group:
                raise ValueError(f"axes {names} name part of the folded axes {group}")
            if hit:
                out.append(i)
        return out


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


# The mesh in scope. A module global, as the launcher's other switches
# (models/sharding.py) are: autograd runs a CUDA backward, and with it a
# remat recompute, on a thread of its own, which a context variable set
# on the caller's thread would not reach.
_SCOPE: list[Mesh | None] = [None]


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Put ``mesh`` in scope (None: no mesh) for the block: the reference's
    ``with mesh:``. The model code reads it through :func:`current_mesh`."""
    _SCOPE.append(mesh)
    try:
        yield mesh
    finally:
        _SCOPE.pop()


def current_mesh() -> Mesh | None:
    """The mesh in scope, or None."""
    return _SCOPE[-1]


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
    taken (JAX's shard_map without replication checks does the same), and
    its gradient goes to every replica divided by their count, as JAX's
    transpose divides an unmapped output's cotangent (``_ReplicaGrad``).
    """
    if tuple(y.shape[:mesh.ndim]) != mesh.shape:
        raise ValueError(f"stacked output of shape {tuple(y.shape)} does not "
                         f"lead with the mesh shape {mesh.shape}")
    nblock = y.ndim - mesh.ndim
    spec = _spec_for(spec, nblock, mesh)
    named = {a for e in spec for a in _names(e)}
    keep = [a for a in mesh.axis_names if a in named]
    index = tuple(slice(None) if a in named else 0 for a in mesh.axis_names)
    y = _TakeReplica.apply(y, index)       # (*kept mesh dims, *block)
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
        if mesh.dist is not None:
            return _shard_map_pg(body, mesh, in_specs, out_specs, args)
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


def placements(spec: Sequence, mesh: Mesh, ndim: int) -> list:
    """DTensor placements of a spec on ``mesh.dist``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` splits over (several, major first, as
    JAX splits; the folded axes are one), ``Replicate()`` on every mesh
    dim the spec does not name."""
    from torch.distributed.tensor import Replicate, Shard

    spec = _spec_for(spec, ndim, mesh)
    out: list = [Replicate()] * len(mesh.dist_axes())
    for d, e in enumerate(spec):
        dims = [mesh.axis(a) for a in _names(e)]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {e!r} must name its mesh axes in the "
                             f"mesh's order {mesh.axis_names} (major first)")
        for m in mesh.dist_dims(_names(e)):
            out[m] = Shard(d)
    return out


def local_block(x: torch.Tensor, spec: Sequence, mesh: Mesh, *,
                even: bool = True) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` on the process-group
    backend: a DTensor is redistributed to the spec's placements (if they
    differ) and its local tensor taken; a plain tensor is the same global
    value on every rank, and its block is cut locally. With ``even`` it
    raises if a dim does not split evenly, as :func:`split` does; without,
    blocks are ``torch.chunk``'s, the first the largest."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    spec = _spec_for(spec, x.ndim, mesh)
    for d, e in enumerate(spec):
        g = int(np.prod([mesh.axis_size(a) for a in _names(e)], dtype=np.int64))
        if even and x.shape[d] % g:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split evenly "
                             f"over mesh axes {_names(e)} of size {g}")
    want = placements(spec, mesh, x.ndim)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x.to(mesh.device), mesh.dist,
                               [Replicate()] * len(mesh.dist_axes()), run_check=False)
    if tuple(x.placements) != tuple(want):
        x = x.redistribute(mesh.dist, want)
    # A block replicated over a mesh dim is used by each rank there on its
    # own: its gradient is a partial sum over them, as the stacked form's
    # expand sums it (and shard_map's replicated outputs give each replica
    # its share of the gradient, _ReplicaGrad).
    return x.to_local(grad_placements=[Partial() if p.is_replicate() else p
                                       for p in want])


def _shard_map_pg(body, mesh: Mesh, in_specs, out_specs, args):
    from torch.distributed.tensor import DTensor

    blocks = [local_block(x, s, mesh) for x, s in zip(args, in_specs)]
    with _active(mesh):
        out = body(*blocks)

    def wrap(o, spec):
        named = {a for e in _spec_for(spec, o.ndim, mesh) for a in _names(e)}
        replicas = int(np.prod([mesh.dist.size(i) for i, group in enumerate(mesh.dist_axes())
                                if not named & set(group)]))
        if replicas > 1 and o.requires_grad:
            o = _ReplicaGrad.apply(o, replicas)
        return DTensor.from_local(o, mesh.dist, placements(spec, mesh, o.ndim),
                                  run_check=False)

    if isinstance(out_specs, P):
        return wrap(out, out_specs)
    if len(out) != len(out_specs):
        raise ValueError(f"body returned {len(out)} outputs for "
                         f"{len(out_specs)} out_specs")
    return type(out)(wrap(o, s) for o, s in zip(out, out_specs))


def lead_dims() -> int:
    """How many leading mesh dims a block has in the running body: the
    mesh's rank on virtual ranks, 0 on the process-group backend."""
    mesh = _mesh()
    return 0 if mesh.dist is not None else mesh.ndim


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
    if mesh.dist is not None:
        (g,) = mesh.dist_dims(axis)
        return torch.tensor(mesh.dist.get_local_rank(g), device=mesh.device)
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
    if mesh.dist is not None:
        return _Permute.apply(x, (mesh.dist, *mesh.dist_dims(axis)), tuple(src_of))
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
    mesh = _mesh()
    if mesh.dist is not None:
        for g in mesh.dist_dims(axis):
            x = _AllReduce.apply(x, (mesh.dist, g))
        return x
    return x.sum(dim=dims, keepdim=True).expand(x.shape)


def pmax(x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
    """Largest value over the ranks along ``axis``; every rank holds it."""
    count("pmax")
    dims = _axes(axis)
    mesh = _mesh()
    if mesh.dist is not None:
        if x.requires_grad:
            raise NotImplementedError("pmax has no backward on the process-group "
                                      "backend")
        for g in mesh.dist_dims(axis):
            x = _reduce(x, "max", (mesh.dist, g))
        return x
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
    if mesh.dist is not None:
        return _AllGather.apply(x, (mesh.dist, *mesh.dist_dims(axis)), dim % x.ndim)
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
    if mesh.dist is not None:
        d = scatter_dimension % x.ndim
        if x.shape[d] % mesh.shape[a]:
            raise ValueError(f"block dim of size {x.shape[d]} does not scatter "
                             f"evenly over {mesh.shape[a]} ranks")
        return _ReduceScatter.apply(x, (mesh.dist, *mesh.dist_dims(axis)), d)
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
    if mesh.dist is not None:
        s, nblock = split_axis % x.ndim, x.ndim
        if x.shape[s] != mesh.shape[a]:
            raise ValueError(f"split dim of size {x.shape[s]} is not the size "
                             f"{mesh.shape[a]} of axis {axis!r}")
        if not -nblock <= concat_axis < nblock:
            raise IndexError(f"concat dim {concat_axis} out of range for "
                             f"{nblock} block dims")
        y = _AllToAll.apply(x.movedim(s, 0), (mesh.dist, *mesh.dist_dims(axis)))
        return y.movedim(0, concat_axis % nblock)
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


# ------------------------------------- collectives on the process groups
# Each is a torch.autograd.Function whose backward is the collective's
# dual, as the stacked form's indexing differentiates: a gather's
# backward reduce-scatters, a sum's sums, an all-to-all and a permute
# send the gradients back the way the values came.
def _funcol():
    import torch.distributed._functional_collectives as funcol

    return funcol


def _on_mesh(name: str, x: torch.Tensor, group) -> torch.Tensor:
    """``x``, contiguous, checked to be a block of the device type of
    ``group`` = (DeviceMesh, dim)."""
    mesh, _ = group
    if x.device.type not in (mesh.device_type, "meta"):
        raise ValueError(f"{name}: a {x.device.type} block on a "
                         f"{mesh.device_type} mesh; a world's ranks keep their "
                         f"blocks on one device type")
    return x.contiguous()


def _wait(t: torch.Tensor) -> torch.Tensor:
    funcol = _funcol()
    if isinstance(t, funcol.AsyncCollectiveTensor):
        return t.wait()
    return funcol.wait_tensor(t)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    funcol = _funcol()
    fn = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return _wait(fn(_on_mesh("all_gather", x, group), dim, group))


def _scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    funcol = _funcol()
    fn = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor
    return _wait(fn(_on_mesh("reduce_scatter", x, group), "sum", dim, group))


def _reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    return _wait(_funcol().all_reduce(_on_mesh(f"all_reduce_{op}", x, group), op, group))


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    return _wait(_funcol().all_to_all_single(_on_mesh("all_to_all", x, group), None, None,
                                             group))


def _route(x: torch.Tensor, group, src_of: tuple[int, ...]) -> torch.Tensor:
    """Rank ``src_of[r]`` sends its block to rank r along the group's mesh
    dim (``funcol.permute_tensor``'s exchange, with a rank that is sent
    nothing getting zeros)."""
    mesh, dim = group
    me = mesh.get_local_rank(dim)
    n = x.numel()
    send = [n if s == me else 0 for s in src_of]
    recv = [0] * len(src_of)
    if src_of[me] >= 0:
        recv[src_of[me]] = n
    flat = _on_mesh("all_to_all_uneven", x.reshape(-1)[:sum(send)], group)
    y = _wait(_funcol().all_to_all_single(flat, recv, send, group))
    return y.reshape(x.shape) if src_of[me] >= 0 else torch.zeros_like(x)


class _ReplicaGrad(torch.autograd.Function):
    """The identity, whose gradient is divided by ``n``. An output
    replicated over mesh axes its spec does not name is taken as one
    replica's value (``assemble`` takes coordinate 0's), and JAX's
    shard_map transposes it by giving every replica the cotangent over
    their count; a DTensor gives the whole gradient to every replica, so
    each keeps its share, and the replicas' inputs sum them (their
    blocks' gradients are partial sums, ``local_block``). Where the
    replicas differ (a rank-local term, as an MoE layer's z-loss), every
    rank's term then counts, as in the reference."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _TakeReplica(torch.autograd.Function):
    """``y[index]`` (one replica along the mesh dims that ``index`` holds
    at 0), whose gradient goes to every replica over their count, as
    ``_ReplicaGrad`` on the process-group backend."""

    @staticmethod
    def forward(ctx, y, index):
        ctx.shape, ctx.index = y.shape, index
        return y[index]

    @staticmethod
    def backward(ctx, g):
        n = 1
        for d, i in enumerate(ctx.index):
            if not isinstance(i, slice):
                g, n = g.unsqueeze(d), n * ctx.shape[d]
        return (g / n).expand(ctx.shape), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, "sum", ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src_of):
        ctx.group = group
        inverse = [-1] * len(src_of)
        for dst, src in enumerate(src_of):
            if src >= 0:
                inverse[src] = dst
        ctx.inverse = tuple(inverse)
        return _route(x, group, src_of)

    @staticmethod
    def backward(ctx, g):
        return _route(g, ctx.group, ctx.inverse), None, None
