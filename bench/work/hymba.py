"""Work of a Hymba step (``bench/reference/hymba.py``'s model).

Operations: 2 x the blocks' matrix parameters x tokens, the head at the
positions whose logits the step returns, attention's QK and PV products
over the causal window band, the scan (7 an element of (token, channel,
state), as ``bench/kernels.py``) and the depthwise conv. Bytes (decode):
every block parameter and the head at the configuration's bf16, and the
cache read and written once.
"""
from __future__ import annotations

from bench import kernels


def _dims(cfg: dict):
    D, H, Kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    di, n, R, F_ = cfg["d_inner"], cfg["ssm_state"], cfg["dt_rank"], cfg["d_ff"]
    return D, H, Kv, hd, di, n, R, F_


def matrix_params(cfg: dict) -> int:
    """Matrix parameters of one block."""
    D, H, Kv, hd, di, n, R, F_ = _dims(cfg)
    attn = 2 * D * H * hd + 2 * D * Kv * hd
    mamba = D * 2 * di + di * 2 * n + di * R + R * di + di * D
    return attn + mamba + 3 * D * F_


def vector_params(cfg: dict) -> int:
    """Parameters of one block outside its matrices: four norms, the conv,
    dt's bias, A and D."""
    D, _, _, _, di, n, _, _ = _dims(cfg)
    return 4 * D + cfg["conv_width"] * di + 2 * di + di * n


def _layer_ops(cfg: dict, B: int, T: int, keys: int, pairs: int) -> float:
    D, H, Kv, hd, di, n, R, F_ = _dims(cfg)
    mats = 2.0 * matrix_params(cfg) * B * T
    attn = 4.0 * hd * H * B * pairs
    scan = 7.0 * B * T * di * n + B * T * di
    conv = 2.0 * cfg["conv_width"] * B * T * di
    return mats + attn + scan + conv


def prefill(cfg: dict, B: int, S: int) -> dict:
    pairs = kernels.attention_pairs(S, cfg["sliding_window"])
    ops = cfg["n_layers"] * _layer_ops(cfg, B, S, S, pairs)
    ops += 2.0 * B * cfg["vocab_size"] * cfg["d_model"]
    return {"flops": ops}


def decode(cfg: dict, B: int, context: int) -> dict:
    """One step of B rows, each with ``context`` tokens before it."""
    W = cfg["sliding_window"]
    keys = min(context + 1, W)
    D, H, Kv, hd, di, n, R, F_ = _dims(cfg)
    L, V = cfg["n_layers"], cfg["vocab_size"]
    ops = L * _layer_ops(cfg, B, 1, keys, keys) + 2.0 * B * V * D
    weights = 2.0 * (L * (matrix_params(cfg) + vector_params(cfg)) + V * D + D)
    cache = L * B * (2.0 * keys * Kv * hd * 2            # keys and values read
                     + 2.0 * 2 * Kv * hd                 # this token's written
                     + 2 * 4.0 * di * n                  # scan state, fp32
                     + 2 * 2.0 * (cfg["conv_width"] - 1) * di)
    return {"flops": ops, "bytes": weights + cache}


def kernel_launches(cfg: dict, B: int, S: int) -> dict:
    """Operations, bytes and dtype of one launch of each kernel a prefill
    runs, by the name its roofline metric gives it."""
    return {
        "flash_bf16": (*kernels.flash(B, S, cfg["n_heads"], cfg["n_kv_heads"],
                                      cfg["head_dim"], cfg["sliding_window"], 2), "bfloat16"),
        "mamba_scan": (*kernels.mamba_scan(B, S, cfg["d_inner"], cfg["ssm_state"]), "float32"),
    }
