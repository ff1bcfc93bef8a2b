"""Elementwise integer tuple arithmetic — the paper's ``Tuple`` type.

Mapple mapping functions are written with tuple arithmetic, e.g.::

    idx = ipoint * m.size / ispace      # block2D  (Fig. 7)
    idx = ipoint % m.size               # cyclic2D
    idx = ipoint / m.size % m.size      # block-cyclic

All operators are elementwise; division is floor division (the paper's
index arithmetic is over naturals). Scalars broadcast.

A :class:`Tup` may also be *batched*: any component may be a NumPy array
carrying a leading batch axis, in which case every operator broadcasts
elementwise per component over the whole batch. This is how the mapper
layer evaluates a mapping function over a full iteration grid in one
vectorized pass (see docs/mapping_ir.md) — the same DSL body runs
unchanged on a scalar point or on B points at once.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np

Scalar = int
TupLike = Union["Tup", Sequence[int], Scalar]


def as_index_component(v):
    """One index/Tup component: a Python int, or a batch axis as an int64
    array. This is THE coercion rule for fractional DSL index values —
    shared by Tup and ProcSpace's batched indexing so the scalar and
    batched paths can never diverge."""
    if isinstance(v, np.ndarray) and v.ndim > 0:
        if v.dtype.kind == "f":
            # Match int()'s truncation; DSL values are naturals, so == floor.
            v = np.trunc(v)
        return v.astype(np.int64, copy=False)
    return int(v)


def _coerce(other: TupLike, n: int) -> tuple:
    if isinstance(other, Tup):
        vals = other._vals
    elif isinstance(other, (list, tuple)):
        vals = tuple(as_index_component(v) for v in other)
    elif isinstance(other, (int, np.integer)):
        return (int(other),) * n
    else:
        # ProcSpace coerces via its .size (duck-typed to avoid circular import)
        size = getattr(other, "size", None)
        if isinstance(size, Tup):
            vals = size._vals
        else:
            raise TypeError(f"cannot coerce {other!r} to Tup")
    if len(vals) != n:
        raise ValueError(f"rank mismatch: {n} vs {len(vals)}")
    return vals


class Tup:
    """Immutable integer tuple with elementwise arithmetic.

    Components are Python ints, or (B,)-shaped int64 arrays when batched.
    """

    __slots__ = ("_vals",)

    def __init__(self, vals: Iterable[int]) -> None:
        object.__setattr__(self, "_vals", tuple(as_index_component(v) for v in vals))

    # -------------------------------------------------------------- protocol
    def __iter__(self):
        return iter(self._vals)

    def __len__(self) -> int:
        return len(self._vals)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return Tup(self._vals[key])
        return self._vals[key]

    def __eq__(self, other) -> bool:
        if isinstance(other, Tup):
            return self._vals == other._vals
        if isinstance(other, tuple):
            return self._vals == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._vals)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Tup{self._vals}"

    # ---------------------------------------------------------------- batching
    @property
    def is_batched(self) -> bool:
        return any(isinstance(v, np.ndarray) for v in self._vals)

    @property
    def batch_size(self) -> int | None:
        """Leading batch extent, or None for a scalar Tup."""
        for v in self._vals:
            if isinstance(v, np.ndarray):
                return int(v.shape[0])
        return None

    @classmethod
    def grid(cls, extents: Sequence[int]) -> "Tup":
        """Batched Tup enumerating every point of ``extents`` in row-major
        order — rank len(extents), batch size prod(extents)."""
        extents = tuple(int(e) for e in extents)
        idx = np.indices(extents, dtype=np.int64).reshape(len(extents), -1)
        return cls(idx)

    # ------------------------------------------------------------ arithmetic
    def _zip(self, other: TupLike, op) -> "Tup":
        o = _coerce(other, len(self._vals))
        return Tup(op(a, b) for a, b in zip(self._vals, o))

    def __mul__(self, other):
        return self._zip(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __rsub__(self, other):
        o = _coerce(other, len(self._vals))
        return Tup(b - a for a, b in zip(self._vals, o))

    def __floordiv__(self, other):
        return self._zip(other, lambda a, b: a // b)

    # The paper writes `/` for natural-number division.
    __truediv__ = __floordiv__

    def __rfloordiv__(self, other):
        o = _coerce(other, len(self._vals))
        return Tup(b // a for a, b in zip(self._vals, o))

    __rtruediv__ = __rfloordiv__

    def __mod__(self, other):
        return self._zip(other, lambda a, b: a % b)

    # ----------------------------------------------------------- conveniences
    def prod(self):
        out = 1
        for v in self._vals:
            out = out * v
        return out

    def linearize(self, extents: TupLike):
        """Row-major linearization of this point within ``extents``."""
        ex = _coerce(extents, len(self._vals))
        out = 0
        for v, e in zip(self._vals, ex):
            out = out * e + v
        return out

    def as_tuple(self) -> tuple:
        return self._vals
