"""Parameter schema system: one source of truth for shapes and init.

The port of ``repro.models.params``. Every model defines a *schema* — a
nested dict whose leaves are :class:`ParamDef` (shape + logical axes +
initializer). From it come ``init_params`` (a nested dict of tensors,
drawn from an explicit ``torch.Generator``), ``abstract_params`` (the
same tree as empty meta tensors) and ``param_count``.

``params_from_numpy`` carries the JAX package's parameter tree across,
key for key (as numpy arrays), so the port and the reference can be run
on the same weights. ``tree_leaves`` and ``tree_map`` walk a nested dict of
tensors in ``jax.tree_util``'s leaf order (keys sorted), for the optimizer
and the checkpoints. ``ShardingRules`` maps a leaf's logical axes onto mesh axes
(``param_specs``, and ``opt_specs`` for the optimizer moments) as the
port's partition specs (``core/spmd.P``), the reference's rules verbatim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.spmd import P

# (generator, shape, dtype, device) -> tensor
Initializer = Callable[[torch.Generator, tuple, torch.dtype, Any], torch.Tensor]


def _randn(gen, shape, device) -> torch.Tensor:
    # The initialisers scale this draw in place: a stacked expert weight
    # is 19 GB in fp32 at deepseek-v2-lite's full width, and a scaled
    # copy beside it would not fit on one card with the other weights.
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def normal_init(stddev: float = 0.02) -> Initializer:
    def fn(gen, shape, dtype, device):
        return _randn(gen, shape, device).mul_(stddev).to(dtype)

    return fn


def scaled_init(fan_in_axis: int = 0) -> Initializer:
    def fn(gen, shape, dtype, device):
        fan_in = shape[fan_in_axis]
        std = 1.0 / math.sqrt(max(fan_in, 1))
        return _randn(gen, shape, device).mul_(std).to(dtype)

    return fn


def zeros_init() -> Initializer:
    def fn(gen, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)

    return fn


def ones_init() -> Initializer:
    def fn(gen, shape, dtype, device):
        return torch.ones(shape, dtype=dtype, device=device)

    return fn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Leaf of a model schema."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: Initializer = dataclasses.field(default_factory=scaled_init)
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


Schema = dict  # nested dict[str, Schema | ParamDef]


def _walk(schema: Schema, fn: Callable[[ParamDef, tuple[str, ...]], Any],
          path: tuple[str, ...] = ()) -> dict:
    out = {}
    for name, node in schema.items():
        if isinstance(node, ParamDef):
            out[name] = fn(node, path + (name,))
        elif isinstance(node, dict):
            out[name] = _walk(node, fn, path + (name,))
        else:
            raise TypeError(f"bad schema node at {path + (name,)}: {node!r}")
    return out


def init_params(schema: Schema, generator: torch.Generator, device="cuda") -> dict:
    """Materialize the schema into tensors on ``device``, leaf by leaf in
    schema order from ``generator`` (which must live on ``device``'s
    type). A seed gives the same weights on every run, but not the JAX
    package's: ``jax.random`` and ``torch.Generator`` differ; carry JAX
    weights across with :func:`params_from_numpy`."""
    return _walk(schema, lambda d, p: d.init(generator, d.shape, d.dtype, device))


def abstract_params(schema: Schema, dtype=None) -> dict:
    """The schema as empty tensors on the meta device, each of its
    ``ParamDef``'s shape and dtype (or ``dtype``): the counterpart of the
    reference's ``ShapeDtypeStruct`` tree, for a count that allocates
    nothing. ``init_params`` cannot serve, since a ``torch.Generator``
    cannot live on the meta device."""
    return _walk(schema, lambda d, p: torch.empty(
        d.shape, dtype=dtype if dtype is not None else d.dtype, device="meta"))


def param_count(schema: Schema) -> int:
    total = 0

    def add(d: ParamDef, path):
        nonlocal total
        total += math.prod(d.shape)
        return 0

    _walk(schema, add)
    return total


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Policy mapping logical parameter axes to mesh axes.

    ``mode``:
      * "tp"    — Megatron tensor parallelism: fused head / ffn / vocab /
                  expert dims shard over ``model_axis``; requires
                  divisibility (checked per-leaf, falls back to replicate).
      * "fsdp"  — ZeRO-3 style: the first shardable dim of every weight
                  shards over ``model_axis``; the mesh gathers it per layer.
    Optionally ``fsdp_data``: additionally shard the first remaining dim
    over the data axis (2D "HSDP" sharding, a hillclimb lever).
    """

    mode: str = "tp"
    model_axis: str = "model"
    data_axis: str | tuple[str, ...] = "data"
    model_size: int = 16
    tp_axes: tuple[str, ...] = (
        "q_fused", "kv_fused", "o_fused", "ffn", "vocab", "experts", "heads",
    )
    fsdp_data: bool = False
    data_size: int = 16

    def spec_for(self, d: ParamDef) -> P:
        if self.mode == "tp":
            entries: list[Any] = []
            used_model = False
            for size, ax in zip(d.shape, d.axes):
                if (
                    not used_model
                    and ax in self.tp_axes
                    and size % self.model_size == 0
                ):
                    entries.append(self.model_axis)
                    used_model = True
                else:
                    entries.append(None)
            if not used_model:
                # Fall back to sharding 'embed' dims (row-parallel) if legal.
                for i, (size, ax) in enumerate(zip(d.shape, d.axes)):
                    if ax == "embed" and size % self.model_size == 0:
                        entries[i] = self.model_axis
                        break
            return P(*entries)
        if self.mode == "fsdp":
            entries = [None] * len(d.shape)
            placed_model = False
            for i, (size, ax) in enumerate(zip(d.shape, d.axes)):
                if ax == "layers":
                    continue  # never shard the scan axis
                if not placed_model and size % self.model_size == 0:
                    entries[i] = self.model_axis
                    placed_model = True
                elif (
                    self.fsdp_data
                    and placed_model
                    and entries[i] is None
                    and size % self.data_size == 0
                ):
                    entries[i] = self.data_axis
                    break
            return P(*entries)
        raise ValueError(f"unknown sharding mode {self.mode!r}")


def param_specs(schema: Schema, rules: ShardingRules) -> dict:
    return _walk(schema, lambda d, p: rules.spec_for(d))


def opt_spec_for(d: ParamDef, rules: ShardingRules) -> P:
    """ZeRO-1: optimizer moments take the param sharding PLUS the data axis
    on the first still-unsharded dim that divides it (elementwise states
    admit any even sharding; the re-gather rides the param update)."""
    base = list(rules.spec_for(d))
    while len(base) < len(d.shape):
        base.append(None)
    for i, (size, ax) in enumerate(zip(d.shape, d.axes)):
        if base[i] is None and ax != "layers" and size % rules.data_size == 0:
            base[i] = rules.data_axis
            break
    return P(*base)


def opt_specs(schema: Schema, rules: ShardingRules) -> dict:
    return _walk(schema, lambda d, p: opt_spec_for(d, rules))


def params_from_numpy(tree, device="cuda") -> dict:
    """The JAX parameter pytree (leaves as numpy arrays, e.g. through
    ``jax.tree.map(np.asarray, params)``) as the port's tensors, key for
    key and dtype for dtype; the stacked ``layers`` axis is kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    # A copy: numpy views of JAX arrays are read-only.
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter (or cache) tree, as views."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def unstack(stacked: dict) -> list[dict]:
    """Every layer of a stacked tree, each leaf taken apart once with
    ``torch.unbind``: under autograd the backward stacks each leaf's
    gradient once, where L ``select`` views (``layer``) would each
    zero-fill a stacked-size gradient."""
    if not isinstance(stacked, dict):
        return list(stacked.unbind(0))
    parts = {k: unstack(v) for k, v in stacked.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys sorted at each level (the order of
    ``jax.tree_util.tree_leaves``); a leaf that is not a dict is itself."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), as a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
