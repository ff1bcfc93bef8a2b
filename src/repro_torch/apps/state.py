"""Carry inputs and state across from numpy into the port's tensors.

Tests hand the same numpy arrays to the JAX package and to this package,
so both compute on identical data: the matmul operands, the stencil
field, PENNANT's ``(rho, e, u, v)`` and the circuit's ``CircuitState``
fields.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.apps.registry import MATMUL, get
from repro_torch.science.circuit import CircuitState

CIRCUIT_FIELDS = ("voltage", "charge", "capacitance", "src", "dst",
                  "resistance")


def _tensor(x: Any, device) -> torch.Tensor:
    """A copy of ``x`` as int64 (indices) or float32, on ``device``."""
    arr = np.asarray(x)
    dtype = torch.int64 if arr.dtype.kind in "iu" else torch.float32
    return torch.tensor(arr, dtype=dtype, device=device)


def state_from_numpy(app_name: str, arrays: Sequence[Any] | Mapping[str, Any],
                     device="cuda"):
    """numpy inputs of ``app_name`` -> the tensors its port runs on.

    * matmul apps: ``(a, b)`` -> a tuple of two float32 tensors;
    * ``stencil``: the field -> one float32 tensor;
    * ``pennant``: ``(rho, e, u, v)`` -> a tuple of four float32 tensors;
    * ``circuit``: a mapping of the ``CircuitState`` field names -> a
      ``CircuitState`` (indices as int64, as ``torch.gather`` wants).
    """
    app = get(app_name)
    if app.kind == MATMUL:
        a, b = arrays
        return _tensor(a, device), _tensor(b, device)
    if app_name == "stencil":
        return _tensor(arrays, device)
    if app_name == "pennant":
        rho, e, u, v = arrays
        return tuple(_tensor(x, device) for x in (rho, e, u, v))
    if app_name == "circuit":
        missing = [f for f in CIRCUIT_FIELDS if f not in arrays]
        if missing:
            raise KeyError(f"circuit state lacks fields {missing}")
        return CircuitState(**{f: _tensor(arrays[f], device)
                               for f in CIRCUIT_FIELDS})
    raise KeyError(f"no state conversion for app {app_name!r}")
