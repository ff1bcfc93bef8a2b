"""MoE dispatch groups: the part of ``repro.models.sharding`` that one card
uses.

Tokens are routed within G independent groups (one per data shard in
production, so the dispatch buffer shards as (G='data', E='model', C, D)).
The reference launcher sets G to ``gcd(dp_total, tokens_per_step)``,
which is 1 on one card; tests set other counts to hold the grouped
dispatch to the reference's.

The rest of that module (``constrain``, ``ShardingRules``,
``param_specs``, the layer barrier) comes with the multi-card substrate;
on one card ``constrain`` is the identity, so the port's models leave
its calls out.
"""
from __future__ import annotations

_MOE_GROUPS: int = 1


def set_moe_groups(g: int) -> None:
    global _MOE_GROUPS
    _MOE_GROUPS = max(1, int(g))


def moe_groups() -> int:
    return _MOE_GROUPS
