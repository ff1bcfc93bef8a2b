"""Activation sharding constraints that degrade gracefully without a mesh.

The port of ``repro.models.sharding``. ``constrain`` and its shorthands
take the reference's *logical* axes, filtered to the mesh in scope
(``spmd.use_mesh``, the reference's ``with mesh:``). The models call them
where the reference does. On a mesh on a process group
(``core/world.py``) a DTensor is redistributed to the spec, as
``with_sharding_constraint`` makes XLA's partitioner do; a plain tensor
comes back as it is, bit for bit, and with virtual ranks in scope the
spec is only checked against the mesh (every rank's block is a slice of
one tensor, so there is nothing to move). Batch axes may span ("pod",
"data").

The module also holds the launcher's switches that the mesh paths read:
sequence sharding (``layers.sp_attention``, ``moe._moe_shard_map``), the
MoE dispatch groups and the layer barrier with its ``bf16_gather`` cast.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import spmd
from repro_torch.models.params import tree_map
from repro_torch import tracing

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"

# Activation policy: when set to "model", residual streams between layers
# are additionally sharded over the model axis on the SEQUENCE dim
# (Megatron-style sequence parallelism), and attention and the MoE take
# their sequence-parallel paths under a mesh. The launcher enables it for
# training and prefill shapes; tests/decode leave it off.
_ACT_SEQ_AXIS: str | None = None

# MoE dispatch groups: tokens are routed within G independent groups (one
# per data shard in production) so the dispatch buffer shards as
# (G='data', E='model', C, D). G=1 off-mesh.
_MOE_GROUPS: int = 1

# Layer barrier: under FSDP the reference pins each layer's parameter
# all-gather inside its scan body with an optimization barrier, so one
# layer's gathered weights live at a time. The launcher sets it for FSDP,
# as the reference's does (see ``layer_barrier``).
_LAYER_BARRIER: bool = False


def set_moe_groups(g: int) -> None:
    global _MOE_GROUPS
    _MOE_GROUPS = max(1, int(g))


def moe_groups() -> int:
    return _MOE_GROUPS


def set_layer_barrier(on: bool) -> None:
    global _LAYER_BARRIER
    _LAYER_BARRIER = bool(on)


def layer_barrier(tree):
    """One layer's parameters at layer entry (the forward loops call it).

    With ``knobs.active().bf16_gather`` every fp32 leaf of two or more
    dims becomes bf16 (before the FSDP all-gather, which then moves half
    the bytes); autograd gives fp32 gradients back through ``.to()``, as
    JAX's ``astype`` does. With the barrier set (FSDP) and a DTensor leaf,
    the leaf is redistributed to ``Replicate()`` on the model axis here:
    the per-layer all-gather happens at layer entry, inside the layer
    loop, and its backward reduce-scatters the gradient there, as the
    reference's ``optimization_barrier`` keeps XLA's gather. On plain
    tensors the barrier is the identity: eager PyTorch runs the loop's
    operations where they stand."""
    from repro_torch.launch.knobs import active

    if active().bf16_gather:
        tree = tree_map(
            lambda p: p.to(torch.bfloat16)
            if p.dtype == torch.float32 and p.ndim >= 2 else p,
            tree,
        )
    mesh = _current_mesh()
    if not _LAYER_BARRIER or mesh is None or mesh.dist is None \
            or MODEL_AXIS not in mesh.axis_names:
        return tree
    (a,) = mesh.dist_dims(MODEL_AXIS)

    def gather(p):
        if not _is_dtensor(p) or p.placements[a].is_replicate():
            return p
        want = list(p.placements)
        want[a] = _replicate()
        return p.redistribute(mesh.dist, want)

    return tree_map(gather, tree)


def decode_layer(tree, x: torch.Tensor):
    """One decode layer's parameters for the token batch ``x`` (B, 1, D).

    On a mesh on a process group, when B does not split over the batch
    axes (long_500k's one sequence), every 2-D-or-more weight that those
    axes replicate is cut over them along its last dim that divides (a
    local cut: every rank there holds it whole), so the ranks along them
    split the layer's products instead of repeating them, as XLA's
    partitioner splits the reference's (hymba-1.5b long_500k: a (100, 344)
    block of each (1600, 5504) FFN weight a chip). Anything else comes
    back as it is."""
    mesh = _current_mesh()
    if mesh is None or mesh.dist is None or not _is_dtensor(x):
        return tree
    axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    dims = mesh.dist_dims(axes) if axes else []
    n = math.prod(mesh.dist.size(m) for m in dims)
    if not dims or x.shape[0] % n == 0:
        return tree
    from torch.distributed.tensor import Shard

    def cut(p):
        if not _is_dtensor(p) or p.ndim < 2 or any(
                not p.placements[m].is_replicate() for m in dims):
            return p
        taken = {q.dim for q in p.placements if q.is_shard()}
        for d in range(p.ndim - 1, -1, -1):
            if d not in taken and p.shape[d] % n == 0:
                want = list(p.placements)
                for m in dims:
                    want[m] = Shard(d)
                return p.redistribute(mesh.dist, want)
        return p

    return tree_map(cut, tree)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for an activation x (..., D) and a weight w (D, F). A 3-D
    DTensor x runs as ``torch.bmm`` against w expanded over its batch:
    ``torch.matmul`` flattens (B, S) first, and DTensor before torch 2.13
    cannot flatten a sequence dim cut over the model axis ("Attempted to
    flatten multiple dimensions, with dimension 1 being sharded", torch
    2.11); a batched product keeps each dim's cut, with the same
    multiplies and adds. Where w's output dim and x's sequence are cut
    over the same mesh dim (a column-parallel weight under sequence
    parallelism), x's sequence is gathered first, as Megatron's sequence
    parallelism does and XLA's partitioner did for the reference; left
    to itself DTensor picks by its cost model, and torch 2.11 picked a
    partial sum that a bias cannot be added to. Any other x is
    multiplied as it is. While a profiler records, each call is a
    ``gemm`` span and adds 2 x rows x D x F to the counter ``gemm.flops``
    (with none, one check: the decode step makes 385 products a step)."""
    if tracing.profiling():
        tracing.count("gemm.flops", 2 * x.numel() * w.shape[-1])
        with tracing.span("gemm"):
            return _proj(x, w)
    return _proj(x, w)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if _is_dtensor(x) and x.ndim == 3 and w.ndim == 2:
        if _is_dtensor(w):
            clash = [m for m, (a, b) in enumerate(zip(x.placements, w.placements))
                     if a.is_shard(1) and b.is_shard(1)]
            if clash:
                x = x.redistribute(x.device_mesh, [
                    _replicate() if m in clash else p for m, p in enumerate(x.placements)])
        return torch.bmm(x, w.expand(x.shape[0], *w.shape))
    return x @ w


def write_at(x: torch.Tensor, value: torch.Tensor, dim: int, index: int) -> torch.Tensor:
    """``x``'s entry ``index`` along ``dim`` set to ``value`` (``x``'s shape
    without ``dim``), in place; returns ``x``. On a DTensor whose ``dim``
    is cut over mesh dims (a decode cache cut along its sequence), an
    indexed assignment makes DTensor gather that dim into a new tensor
    and write there, leaving ``x`` as it was; here the rank whose block
    holds ``index`` writes its block of ``value`` into its own, cut as
    ``torch.chunk`` cuts (DTensor's rule), mesh dim by mesh dim."""
    if not _is_dtensor(x) or not any(p.is_shard(dim) for p in x.placements):
        x.select(dim, index).copy_(value)
        return x
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    want = [_replicate() if p.is_shard(dim) else
            Shard(p.dim - (p.dim > dim)) if p.is_shard() else p for p in x.placements]
    local = value.redistribute(mesh, want).to_local()
    size, offset = x.shape[dim], 0
    for m, p in enumerate(x.placements):
        if p.is_shard(dim):
            step = -(-size // mesh.size(m))
            lo = min(mesh.get_local_rank(m) * step, size)
            offset, size = offset + lo, min(lo + step, size) - lo
    if offset <= index < offset + size:
        x.to_local().select(dim, index - offset).copy_(local)
    return x


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _replicate():
    from torch.distributed.tensor import Replicate

    return Replicate()


def set_sequence_sharding(axis: str | None) -> None:
    global _ACT_SEQ_AXIS
    _ACT_SEQ_AXIS = axis


def seq_axis() -> str | None:
    return _ACT_SEQ_AXIS


def residual(x: torch.Tensor) -> torch.Tensor:
    """Constraint for the (B, S, D) residual stream between layers."""
    return constrain(x, BATCH_AXES, _ACT_SEQ_AXIS, None)


def _current_mesh() -> spmd.Mesh | None:
    """The mesh in scope (``spmd.use_mesh``), or None."""
    return spmd.current_mesh()


def _mesh_axis_names() -> tuple[str, ...]:
    mesh = _current_mesh()
    return tuple(mesh.axis_names) if mesh is not None else ()


def _filter(entry, names: tuple[str, ...]):
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None
    return entry if entry in names else None


def constrain(x: torch.Tensor, *entries) -> torch.Tensor:
    """The reference's ``with_sharding_constraint(x, P(*entries))``,
    filtered to live mesh axes: entries may be axis names, tuples of names,
    or None; a dim whose size does not divide falls back to unsharded.
    A DTensor on the mesh in scope is redistributed to the spec; any
    other tensor comes back as it is, once its spec is checked."""
    mesh = _current_mesh()
    if mesh is None:
        return x
    names = mesh.axis_names
    spec_entries = []
    for dim, e in zip(range(x.ndim), list(entries) + [None] * (x.ndim - len(entries))):
        f = _filter(e, names)
        if f is not None:
            total = 1
            for a in (f if isinstance(f, tuple) else (f,)):
                total *= mesh.axis_size(a)
            if x.shape[dim] % total != 0:
                f = None
        spec_entries.append(f)
    spec = spmd.P(*spec_entries)
    if mesh.dist is None or not _is_dtensor(x):
        spmd._spec_for(spec, x.ndim, mesh)
        return x
    return _Constrain.apply(x, mesh.dist, tuple(spmd.placements(spec, mesh, x.ndim)))


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``want``, its gradient redistributed back
    to the input's placements. XLA transposes ``with_sharding_constraint``
    into the same constraint on the cotangent; where the forward moved
    nothing (the input already had ``want``) this is that constraint, and
    it keeps DTensor's backward on the spec. Where it moved the input,
    the gradient goes back to the layout the input's producer has (a
    reshape's backward cannot always unflatten a dim sharded as ``want``,
    e.g. 9 heads x 64 over 16 ranks)."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        # a pending sum's gradient is whole on every rank (the sum's adjoint)
        ctx.mesh = mesh
        ctx.came = tuple(_replicate() if p.is_partial() else p for p in x.placements)
        return _redistribute(x, mesh, want)

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, ctx.mesh, ctx.came), None, None


def _redistribute(x, mesh, want):
    if tuple(x.placements) == tuple(want):
        return x.view_as(x)
    return x.redistribute(mesh, list(want))


def split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n * d) -> (..., n, d). A DTensor whose last dim is cut over
    more ranks than ``n`` divides by has that dim gathered first: DTensor
    cannot cut n heads into a count of blocks n does not divide (XLA pads
    them), e.g. 8 kv heads over a 16-way model axis."""
    if _is_dtensor(x):
        last = x.ndim - 1
        cut = [m for m, p in enumerate(x.placements) if p.is_shard(last)]
        if n % math.prod(x.device_mesh.size(m) for m in cut):
            want = [_replicate() if m in cut else p for m, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, want)
    return x.reshape(*x.shape[:-1], n, d)


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` whole on every rank: a DTensor cut along it is
    gathered; any other tensor comes back as it is. A recurrence over time
    gathers its sequence-sharded inputs once, before its loop, as XLA
    hoists the gather out of its scan; DTensor would gather them again
    for every step it indexes."""
    if _is_dtensor(x) and any(p.is_shard(dim % x.ndim) for p in x.placements):
        want = [_replicate() if p.is_shard(dim % x.ndim) else p for p in x.placements]
        x = x.redistribute(x.device_mesh, want)
    return x


def microbatches(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n, B / n, ...), microbatch i the rows [i B / n, (i + 1)
    B / n). A DTensor cut along its batch has each microbatch cut the same
    way: the batch is gathered, reshaped and cut again along each
    microbatch's rows (DTensor cannot cut n microbatches over more ranks
    than n divides by; XLA reshuffles the token batch likewise). Where a
    microbatch's rows do not split over those ranks, each holds it whole,
    as ``constrain`` leaves a dim that does not divide."""
    if _is_dtensor(x) and any(p.is_shard(0) for p in x.placements):
        from torch.distributed.tensor import Shard

        mesh = x.device_mesh
        cut = [p.is_shard(0) for p in x.placements]
        whole = x.redistribute(mesh, [
            _replicate() if c else p for c, p in zip(cut, x.placements)])
        y = whole.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
        if (x.shape[0] // n) % math.prod(mesh.size(m) for m, c in enumerate(cut) if c):
            return y
        return y.redistribute(mesh, [
            Shard(1) if c else p for c, p in zip(cut, x.placements)])
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., n, d) -> (..., n * d), the heads dim gathered first on a
    DTensor that cuts it over more ranks than n divides by (DTensor
    cannot flatten it; see ``split_heads``)."""
    if _is_dtensor(x):
        heads = x.ndim - 2
        cut = [m for m, p in enumerate(x.placements) if p.is_shard(heads)]
        if x.shape[heads] % math.prod(x.device_mesh.size(m) for m in cut):
            want = [_replicate() if m in cut else p for m, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, want)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def batch_sharded(x: torch.Tensor) -> torch.Tensor:
    """Shard the leading batch dim over (pod, data)."""
    return constrain(x, BATCH_AXES)


def logits_sharded(x: torch.Tensor) -> torch.Tensor:
    """Shard the vocab (last) dim of logits over the model axis."""
    entries = [BATCH_AXES] + [None] * (x.ndim - 2) + [MODEL_AXIS]
    return constrain(x, *entries)
