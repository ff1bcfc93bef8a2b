"""Gradient compression with error feedback (distributed-optimization trick).

The port of ``repro.runtime.compression``. int8 block-quantized gradients
before the data-parallel all-reduce: 4x (fp32) / 2x (bf16) less wire
volume on the dominant collective, with an error-feedback accumulator so
the quantization bias does not accumulate across steps (Seide et al.
2014; Karimireddy et al. 2019 style).

On one card there is no all-reduce: the pair models the numerics (what
lands in the optimizer). ``torch.round`` rounds half to even, as
``jnp.round`` does, so ``q`` is the reference's bit for bit. The error
buffer is part of the train state.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.params import tree_map

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 quantization. Returns (q, scales)."""
    flat, _ = _pad_to_block(x.to(torch.float32))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compress_tree(grads: Any, error: Any) -> tuple[Any, Any]:
    """Quantize (grads + error); new error = input - dequantized.

    Returns (compressed_grads_as_float, new_error), trees shaped as
    ``grads``. The compressed values are exactly representable in int8
    blocks.
    """

    def one(g, e):
        x = g.to(torch.float32) + e
        q, s = quantize(x)
        deq = dequantize(q, s, g.shape, torch.float32)
        return deq, x - deq

    return _unzip(tree_map(one, grads, error))


def _unzip(tree):
    """A tree of pairs as a pair of trees."""
    if not isinstance(tree, dict):
        return tree
    parts = {k: _unzip(v) for k, v in tree.items()}
    return ({k: p[0] for k, p in parts.items()},
            {k: p[1] for k, p in parts.items()})


def init_error(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
