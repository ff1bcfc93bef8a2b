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

The port's copy of ``repro.launch.knobs``. On one card ``bf16_gather``
and ``sp_attention`` name nothing yet (they act on the mesh), and
``attn_chunks`` reaches no call: ``chunked_attention`` binds
``Q_CHUNK``/``KV_CHUNK`` as defaults when it is defined, in both
packages, so only the reference's sequence-parallel call reads them.
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
