"""Work of an RWKV-6 step (``bench/reference/rwkv6.py``'s model).

Operations: 2 x the blocks' matrix parameters x tokens, the head at the
positions whose logits the step returns, and the WKV recurrence (5 N^2 a
(batch, head, step), as ``bench/kernels.py``). Bytes (decode): every block
parameter and the head at the configuration's bf16, and the state read and
written once.
"""
from __future__ import annotations

from bench import kernels

HEAD = 64


def matrix_params(cfg: dict) -> int:
    """Matrix parameters of one block."""
    D, F_, R = cfg["d_model"], cfg["d_ff"], cfg["decay_lora"]
    return 5 * D * D + 2 * D * R + D * D + 2 * D * F_


def vector_params(cfg: dict) -> int:
    """Two norms, seven lerp weights, w0, u and the WKV output norm."""
    return 12 * cfg["d_model"]


def _layer_ops(cfg: dict, B: int, T: int) -> float:
    H = cfg["d_model"] // HEAD
    return 2.0 * matrix_params(cfg) * B * T + 5.0 * HEAD * HEAD * B * H * T


def prefill(cfg: dict, B: int, S: int) -> dict:
    ops = cfg["n_layers"] * _layer_ops(cfg, B, S) + 2.0 * B * cfg["vocab_size"] * cfg["d_model"]
    return {"flops": ops}


def decode(cfg: dict, B: int, context: int) -> dict:
    D, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab_size"]
    H = D // HEAD
    ops = L * _layer_ops(cfg, B, 1) + 2.0 * B * V * D
    weights = 2.0 * (L * (matrix_params(cfg) + vector_params(cfg)) + V * D + D)
    state = L * B * (2 * 4.0 * H * HEAD * HEAD + 2 * 2 * 2.0 * D)
    return {"flops": ops, "bytes": weights + state}


def kernel_launches(cfg: dict, B: int, S: int) -> dict:
    H = cfg["d_model"] // HEAD
    return {"wkv6": (*kernels.wkv6(B, S, H, HEAD), "float32")}
