"""Activation sharding constraints that degrade gracefully without a mesh.

The port of ``repro.models.sharding`` on the single-process substrate
(``core/spmd.py``). ``constrain`` and its shorthands take the reference's
*logical* axes: with a mesh in scope (``spmd.use_mesh``, the reference's
``with mesh:``) ``constrain`` checks the spec against it, and with none
it returns at once. Either way it returns ``x`` as it is: a sharding
constraint leaves values unchanged, and on one process every rank's block
is a slice of one tensor, so there is nothing to move. Batch axes may
span ("pod", "data"). The model families do not call them: under a mesh
each call would only rebuild and check a spec every layer, and a wrong
split already raises in ``spmd.split`` when ``shard_map`` runs. They go
back at the reference's sites with a substrate on which a constraint
moves data.

The module also holds the launcher's switches that the mesh paths read:
sequence sharding (``layers.sp_attention``, ``moe._moe_shard_map``), the
MoE dispatch groups and the layer barrier with its ``bf16_gather`` cast.
"""
from __future__ import annotations

import torch

from repro_torch.core import spmd
from repro_torch.models.params import tree_map

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
# as the reference's does; in eager PyTorch it changes nothing (see
# ``layer_barrier``).
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
    dims becomes bf16 (in the reference, before the FSDP all-gather, which
    then moves half the bytes); autograd gives fp32 gradients back through
    ``.to()``, as JAX's ``astype`` does. The barrier itself is the
    identity here, so ``set_layer_barrier``'s flag has no effect: the
    reference's ``optimization_barrier`` only stops XLA from hoisting the
    gathers out of the layer loop, and eager PyTorch runs the loop's
    operations where they stand."""
    from repro_torch.launch.knobs import active

    if not active().bf16_gather:
        return tree
    return tree_map(
        lambda p: p.to(torch.bfloat16)
        if p.dtype == torch.float32 and p.ndim >= 2 else p,
        tree,
    )


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
    The spec is checked against the mesh in scope; ``x`` comes back as
    it is."""
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
    spmd._spec_for(spmd.P(*spec_entries), x.ndim, mesh)
    return x


def batch_sharded(x: torch.Tensor) -> torch.Tensor:
    """Shard the leading batch dim over (pod, data)."""
    return constrain(x, BATCH_AXES)


def logits_sharded(x: torch.Tensor) -> torch.Tensor:
    """Shard the vocab (last) dim of logits over the model axis."""
    entries = [BATCH_AXES] + [None] * (x.ndim - 2) + [MODEL_AXIS]
    return constrain(x, *entries)
