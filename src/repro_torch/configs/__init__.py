"""Assigned-architecture configs (public literature, exact dims).

``get_config(arch_id)`` returns the full config; ``--arch <id>`` in the
launchers resolves through this registry.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "h2o-danube-1.8b",
    "granite-3-2b",
    "qwen2-7b",
    "smollm-135m",
    "deepseek-v2-lite-16b",
    "qwen2-moe-a2.7b",
    "rwkv6-3b",
    "musicgen-medium",
    "hymba-1.5b",
    "pixtral-12b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}"
        )
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
