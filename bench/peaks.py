"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time a piece of work
can take on it. A frozen copy of ``chip_smoke.py``'s ``bound_ms``."""
from __future__ import annotations

PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The larger of operations over the dtype's peak and bytes over the
    memory bandwidth, in seconds, and which of the two it is."""
    t_ops = ops / PEAK_OPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
