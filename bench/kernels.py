"""Operations and bytes of one launch of each hand-written LM kernel, from
its shapes alone: a frozen copy of ``chip_smoke.py``'s arithmetic. Each
input byte is read once and each output byte written once."""
from __future__ import annotations


def attention_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal mask within ``window`` (0: none) lets
    through in one sequence of length S."""
    if window <= 0 or S <= window:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash(B: int, S: int, H: int, Kv: int, d: int, window: int, itemsize: int):
    """QK and PV products over the pairs; q, k, v read and o written."""
    ops = 4.0 * d * B * H * attention_pairs(S, window)
    nbytes = itemsize * (2 * B * S * H * d + 2 * B * S * Kv * d)
    return ops, nbytes


def mamba_scan(B: int, T: int, di: int, n: int):
    """7 operations a (token, channel, state) element (discretise, decay,
    update, read out) and one a (token, channel); fp32 in and out."""
    ops = 7.0 * B * T * di * n + B * T * di
    nbytes = 4.0 * (3 * B * T * di + 2 * B * T * n + di * n + B * di * n)
    return ops, nbytes


def wkv6(B: int, T: int, H: int, N: int):
    """5 N^2 operations a (batch, head, step): r.S, the decay, the outer
    product and the sum of the state update; fp32 in and out."""
    ops = 5.0 * N * N * B * H * T
    nbytes = 4.0 * (5 * B * T * H * N + H * N + B * H * N * N)
    return ops, nbytes
