"""Step functions of the LM serving path (``repro.launch.steps.make_cell``'s
prefill and decode branches).

The reference builds a lowering cell per (arch x shape): a step callable
plus abstract arguments and shardings for XLA. On one card the step
callables are all that is left: sharding, lowering and donation are
XLA's and wait for the XLA-tools slice; the train step comes with the
training slice.
"""
from __future__ import annotations

from typing import Callable

import torch


def make_prefill_step(model, use_kernel: bool = True) -> Callable:
    """``prefill_step(params, inputs)`` -> last-position logits (B,1,V):
    the serving prefill, with ``use_kernel`` through the model family's
    kernels: flash-attention for the dense and MoE decoders (qwen2-moe at
    head dim 128), flash-attention and selective scan for Hymba, WKV6 for
    RWKV-6. MLA (deepseek-v2-lite) has no kernel route, as in the
    reference: it serves with ``use_kernel=False``, and with ``True`` the
    step raises a ``ValueError``."""

    @torch.no_grad()
    def prefill_step(params, inputs):
        return model.last_logits(params, inputs, use_kernel=use_kernel)

    return prefill_step


def make_serve_step(model) -> Callable:
    """``serve_step(params, cache, pos, token)`` -> (logits, cache): one
    decode step; the cache is updated in place."""

    @torch.no_grad()
    def serve_step(params, cache, pos, token):
        return model.decode_step(params, cache, pos, token)

    return serve_step
