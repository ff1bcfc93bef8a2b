"""AdamW with global-norm clipping, cosine schedule, mixed precision.

The port of ``repro.training.optimizer``, with its arithmetic: float32
bias corrections ``b ** step``, weight decay on every leaf, gradients
cast to fp32, leaves in ``jax.tree_util``'s order. The reference's jit
donates the train state (``repro.launch.steps``), so ``update`` writes
the parameters and the moments in place, under ``torch.no_grad()``, and
returns them as the reference returns its new ones. The ZeRO-1 sharding
of the moments is ``launch/policy.ShardingPlan.opt_moments``' spec; one
process keeps the moments whole.

Gradient compression (int8 error-feedback) is applied by the train step
before it calls ``update``; see ``repro_torch/runtime/compression.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any              # first moment  (tree like params)
    nu: Any              # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` of ``lr``;
    ``step`` an integer tensor, the result float32."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def init(params) -> AdamWState:
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step, in place. Returns (params, new_state, metrics); the
    metrics are tensors on the parameters' device."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g32 = g.to(torch.float32)
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g32))
        p32 = p.to(torch.float32)
        new_p = p32 - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                            + cfg.weight_decay * p32)
        p.copy_(new_p)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.mu, state.nu), metrics
