"""Hillclimb knobs: named optimization levers the §Perf loop toggles.

Each knob is applied before a cell is lowered and reset after, so the
same process can A/B a lever:

  wkv_impl          — "scan" (baseline) | "chunked" (flash-linear-attention)
  moe_capacity      — MoE capacity factor (baseline 1.25)
  bf16_gather       — cast params to bf16 at layer entry so FSDP
                      all-gathers move half the bytes
  microbatch        — override gradient-accumulation factor (0 = policy)
  attn_chunks       — (q_chunk, kv_chunk) for the online-softmax attention
  sp_attention      — shard_map sequence-parallel attention (vs letting the
                      SPMD partitioner reshard the chunk loop)

The port's copy of ``repro.launch.knobs``. ``bf16_gather`` acts in both
packages with or without a mesh: ``models/sharding.layer_barrier`` casts
each layer's fp32 weights of two or more dims to bf16 at layer entry in
the forward loops. ``sp_attention`` gates ``layers.sp_attention`` and
``sp_decode_attention`` under a mesh in scope. ``attn_chunks`` sets
``Q_CHUNK``/``KV_CHUNK``, which only ``sp_attention`` reads at its call
(``chunked_attention`` binds them as defaults when it is defined, in
both packages).
"""
from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class Knobs:
    wkv_impl: str = "scan"
    moe_capacity: float = 1.25
    bf16_gather: bool = False
    microbatch: int = 0
    attn_chunks: tuple[int, int] = (1024, 1024)
    sp_attention: bool = True


_ACTIVE = Knobs()


def active() -> Knobs:
    return _ACTIVE


@contextlib.contextmanager
def apply(knobs: Knobs):
    """Install the knobs into the relevant modules for one lowering."""
    from repro_torch.models import layers, moe, rwkv6

    global _ACTIVE
    saved = (
        rwkv6.WKV_IMPL, moe.CAPACITY_FACTOR, layers.Q_CHUNK, layers.KV_CHUNK,
        _ACTIVE,
    )
    try:
        rwkv6.set_wkv_impl(knobs.wkv_impl)
        moe.CAPACITY_FACTOR = knobs.moe_capacity
        layers.Q_CHUNK, layers.KV_CHUNK = knobs.attn_chunks
        _ACTIVE = knobs
        yield knobs
    finally:
        rwkv6.set_wkv_impl(saved[0])
        moe.CAPACITY_FACTOR = saved[1]
        layers.Q_CHUNK, layers.KV_CHUNK = saved[2], saved[3]
        _ACTIVE = saved[4]
