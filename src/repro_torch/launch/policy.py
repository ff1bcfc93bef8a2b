"""Sharding policy: map each arch's logical axes onto the production mesh.

The port of ``repro.launch.policy``. The planner applies the Mapple
decompose philosophy at the framework level: given the fixed
(data=16, model=16) pod mesh, choose per-arch between

  * "tp"   — Megatron tensor parallelism on the model axis (requires the
             fused head / ffn / expert dims to divide 16); activations DP.
  * "fsdp" — ZeRO-3 parameter sharding on the model axis (any arch whose
             head counts do not divide 16: qwen2-7b 28H, smollm 9H,
             musicgen 24H, hymba 25H, rwkv6 40H); gathered per layer.

plus the batch specification over ("pod", "data"). A sharding is a
:class:`NamedSharding` record of a mesh and a spec, filtered to the
mesh's axes; ``apply`` cuts a global tensor into the mesh's stacked
blocks (``spmd.split``), and on a mesh on a process group
(``core/world.py``) ``placements`` and ``distribute`` give the DTensor
of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import spmd
from repro_torch.core.spmd import P
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ShardingRules, opt_specs, param_specs, tree_map

BATCH = ("pod", "data")
MODEL_AXIS_SIZE = 16


def choose_mode(cfg: ModelConfig) -> str:
    tp_ok = (
        cfg.n_heads % MODEL_AXIS_SIZE == 0
        and (cfg.n_experts == 0 or cfg.padded_experts % MODEL_AXIS_SIZE == 0)
        and (cfg.d_ff % MODEL_AXIS_SIZE == 0 or cfg.n_experts > 0)
    )
    return "tp" if tp_ok else "fsdp"


def make_rules(cfg: ModelConfig, mode: str | None = None) -> ShardingRules:
    return ShardingRules(
        mode=mode or choose_mode(cfg),
        model_axis="model",
        data_axis="data",
        model_size=MODEL_AXIS_SIZE,
    )


def _filter_spec(spec: P, mesh: spmd.Mesh) -> P:
    """Drop axes not present in the mesh (single-pod vs multi-pod)."""
    names = set(mesh.axis_names)
    entries = []
    for e in spec:
        if e is None:
            entries.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a in names)
            entries.append(kept if kept else None)
        else:
            entries.append(e if e in names else None)
    return P(*entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: the reference's ``jax.sharding.NamedSharding``."""

    mesh: spmd.Mesh
    spec: P

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the mesh's device as stacked ``(*mesh.shape, *block)``
        blocks; raises if a dim does not split evenly."""
        return spmd.split(x.to(self.mesh.device), self.spec, self.mesh)

    def placements(self, ndim: int | None = None) -> list:
        """The spec as DTensor placements on the mesh's ``DeviceMesh``: an
        entry over several axes shards its dim on each of them, major
        first; a mesh axis the spec does not name replicates."""
        return spmd.placements(self.spec, self.mesh,
                               len(self.spec) if ndim is None else ndim)

    def local_shape(self, shape) -> tuple[int, ...]:
        """The block of a ``shape`` tensor at mesh position (0, ..., 0):
        each sharded dim cut by ``torch.chunk`` over its axes in turn, so
        an uneven split leaves this block the largest."""
        out = list(shape)
        for d, e in enumerate(spmd._spec_for(self.spec, len(out), self.mesh)):
            for a in spmd._names(e):
                out[d] = -(-out[d] // self.mesh.axis_size(a))
        return tuple(out)

    def distribute(self, x: torch.Tensor):
        """``x`` (a global tensor, or a meta one) as a DTensor on the mesh's
        ``DeviceMesh``: this rank's block of it, under the spec."""
        if self.mesh.dist is None:
            raise ValueError("distribute needs a mesh on a process group "
                             "(core/world.py::on_world)")
        from torch.distributed.tensor import DTensor

        if x.device.type == "meta":
            local = torch.empty(self.local_shape(x.shape), dtype=x.dtype, device="meta")
        else:
            local = spmd.local_block(x, self.spec, self.mesh, even=False)
        return DTensor.from_local(local, self.mesh.dist, self.placements(x.ndim),
                                  run_check=False, shape=x.shape,
                                  stride=torch.empty(x.shape, device="meta").stride())


def shard(mesh: spmd.Mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, _filter_spec(spec, mesh))


def _shape(x) -> tuple[int, ...]:
    """A tensor's shape, or the shape of a ``cache_spec`` (shape, dtype)."""
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x[0])


@dataclasses.dataclass
class ShardingPlan:
    mesh: spmd.Mesh
    rules: ShardingRules
    mode: str

    def _dp(self) -> int:
        total = 1
        for a in BATCH:
            if a in self.mesh.axis_names:
                total *= self.mesh.axis_size(a)
        return total

    def params(self, schema) -> Any:
        return tree_map(lambda s: shard(self.mesh, s), param_specs(schema, self.rules))

    def opt_moments(self, schema) -> Any:
        """ZeRO-1 moment shardings (param specs + data axis)."""
        return tree_map(lambda s: shard(self.mesh, s), opt_specs(schema, self.rules))

    def replicated(self) -> NamedSharding:
        return shard(self.mesh, P())

    def batch_like(self, tree) -> Any:
        """Shard leading dim over (pod, data) when divisible."""
        total = self._dp()

        def one(x):
            shape = _shape(x)
            b = shape[0] if shape else 1
            if b % max(total, 1) == 0 and len(shape) >= 1 and total > 1:
                return shard(self.mesh, P(BATCH))
            return self.replicated()

        return tree_map(one, tree)

    def cache(self, cache_spec: dict) -> dict:
        """KV/state caches: batch dim over (pod, data) when divisible;
        the model axis takes the kv-head dim when it divides, else the
        cache SEQUENCE dim (sequence-parallel KV cache — the long-context
        serving layout; attention reductions cross shards through
        ``layers.sp_decode_attention``). Values are tensors or the
        models' ``cache_spec`` (shape, dtype) pairs."""
        total = self._dp()

        def one(x):
            # layouts: (L, B, C, Kv, hd) | (L, B, C, r) | (L, B, H, N, N) |
            #          (L, B, W, di) | (L, B, di, n) | (L, B, D)
            shape = _shape(x)
            entries: list[Any] = [None] * len(shape)
            if len(shape) >= 2 and shape[1] % max(total, 1) == 0 and total > 1:
                entries[1] = BATCH
            if len(shape) >= 5 and shape[3] % MODEL_AXIS_SIZE == 0:
                entries[3] = "model"              # kv heads
            elif len(shape) >= 4 and shape[2] % MODEL_AXIS_SIZE == 0:
                entries[2] = "model"              # cache sequence dim
            return shard(self.mesh, P(*entries))

        return {k: one(v) for k, v in cache_spec.items()}


def make_plan(cfg: ModelConfig, mesh: spmd.Mesh, mode: str | None = None) -> ShardingPlan:
    m = mode or choose_mode(cfg)
    return ShardingPlan(mesh=mesh, rules=make_rules(cfg, m), mode=m)
