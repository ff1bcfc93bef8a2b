"""Processor-space algebra: the core of the Mapple DSL.

Implements the transformation primitives of Fig. 6 of the paper
("Mapple: A DSL for Mapping Distributed Heterogeneous Parallel Programs"):

    split(i, d)            -- split dim i into (d, s_i/d)
    merge(p, q)            -- fuse dims p and q into one dim at p
    swap(p, q)             -- exchange two dims
    slice(i, low, high)    -- restrict dim i to [low, high) with offset
    decompose(i, T)        -- optimally factor dim i against iteration extents T

A transformed :class:`ProcSpace` is *data*, not code: it records its root
shape plus the list of applied transformation ops (the mapping IR). The ops
know how to map indices of the transformed space back to the *root* space
indices (the machine's physical coordinates), exactly as the paper defines
the semantics: "mappings from the indices of the transformed processor
space to the indices of the original processor space" — both one point at
a time (:meth:`ProcSpace.to_root`) and vectorized over a whole batch of
points with pure NumPy index arithmetic (:meth:`ProcSpace.to_root_batch`).

Because the transformation program is explicit, spaces are printable
(:meth:`ProcSpace.describe`) and serializable (:meth:`ProcSpace.to_ir` /
:meth:`ProcSpace.from_ir`) — see docs/mapping_ir.md.

All spaces are immutable; primitives return new spaces sharing the same root.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.tuples import Tup, as_index_component

Index = tuple[int, ...]


def _prod(xs: Sequence[int]) -> int:
    return math.prod(xs) if xs else 1


# ------------------------------------------------------------------ the IR
@dataclasses.dataclass(frozen=True)
class Op:
    """One recorded transformation: maps indices of the space it produced
    back to indices of the space it was applied to (view -> parent)."""

    def apply(self, idx: Index) -> Index:  # pragma: no cover - abstract
        raise NotImplementedError

    def apply_batch(self, idx: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def spec(self) -> tuple:  # pragma: no cover - abstract
        """JSON-able (opname, *args) tuple for serialization."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Split(Op):
    """Fig. 6 split(i, d): ``m'[.., a_i, a_{i+1}, ..] = m[.., a_i + a_{i+1}*d, ..]``."""

    dim: int
    factor: int

    def apply(self, idx: Index) -> Index:
        i, d = self.dim, self.factor
        return idx[:i] + (idx[i] + idx[i + 1] * d,) + idx[i + 2:]

    def apply_batch(self, idx: np.ndarray) -> np.ndarray:
        i, d = self.dim, self.factor
        out = np.empty((idx.shape[0], idx.shape[1] - 1), dtype=idx.dtype)
        out[:, :i] = idx[:, :i]
        out[:, i] = idx[:, i] + idx[:, i + 1] * d
        out[:, i + 1:] = idx[:, i + 2:]
        return out

    def spec(self) -> tuple:
        return ("split", self.dim, self.factor)

    def __str__(self) -> str:
        return f"split({self.dim}, {self.factor})"


@dataclasses.dataclass(frozen=True)
class Merge(Op):
    """Fig. 6 merge(p, q): ``m'[.., a_p, ..] = m[.., a_p mod s_p, .., a_p / s_p, ..]``.

    ``extent_p`` is the extent of dim p at the time the merge was applied
    (needed to unfuse the combined coordinate).
    """

    p: int
    q: int
    extent_p: int

    def apply(self, idx: Index) -> Index:
        p, q, sp = self.p, self.q, self.extent_p
        ap = idx[p]
        # idx has rank n-1; idx[p+1:q] are the dims strictly between p and q,
        # and idx[q:] are the post-q dims (shifted left by one in idx).
        return idx[:p] + (ap % sp,) + idx[p + 1:q] + (ap // sp,) + idx[q:]

    def apply_batch(self, idx: np.ndarray) -> np.ndarray:
        p, q, sp = self.p, self.q, self.extent_p
        out = np.empty((idx.shape[0], idx.shape[1] + 1), dtype=idx.dtype)
        out[:, :p] = idx[:, :p]
        out[:, p] = idx[:, p] % sp
        out[:, p + 1:q] = idx[:, p + 1:q]
        out[:, q] = idx[:, p] // sp
        out[:, q + 1:] = idx[:, q:]
        return out

    def spec(self) -> tuple:
        return ("merge", self.p, self.q)

    def __str__(self) -> str:
        return f"merge({self.p}, {self.q})"


@dataclasses.dataclass(frozen=True)
class Swap(Op):
    """Fig. 6 swap(p, q): exchange two dims."""

    p: int
    q: int

    def apply(self, idx: Index) -> Index:
        b = list(idx)
        b[self.p], b[self.q] = idx[self.q], idx[self.p]
        return tuple(b)

    def apply_batch(self, idx: np.ndarray) -> np.ndarray:
        out = idx.copy()
        out[:, self.p] = idx[:, self.q]
        out[:, self.q] = idx[:, self.p]
        return out

    def spec(self) -> tuple:
        return ("swap", self.p, self.q)

    def __str__(self) -> str:
        return f"swap({self.p}, {self.q})"


@dataclasses.dataclass(frozen=True)
class Slice(Op):
    """Fig. 6 slice(i, low, high): ``m'[.., a_i, ..] = m[.., a_i + low, ..]``."""

    dim: int
    low: int
    high: int

    def apply(self, idx: Index) -> Index:
        i = self.dim
        return idx[:i] + (idx[i] + self.low,) + idx[i + 1:]

    def apply_batch(self, idx: np.ndarray) -> np.ndarray:
        out = idx.copy()
        out[:, self.dim] += self.low
        return out

    def spec(self) -> tuple:
        return ("slice", self.dim, self.low, self.high)

    def __str__(self) -> str:
        return f"slice({self.dim}, {self.low}, {self.high})"


@dataclasses.dataclass(frozen=True)
class Decompose(Op):
    """Sec. 4 decompose: dim i factored into ``factors`` (a split sequence).

    Semantically identical to applying ``split(i, f_0)``, ``split(i+1, f_1)``,
    ... — the k view coordinates recombine little-endian mixed-radix:
    ``a_i = sum_j x_{i+j} * prod(factors[:j])``.
    """

    dim: int
    factors: tuple[int, ...]

    def apply(self, idx: Index) -> Index:
        i, k = self.dim, len(self.factors)
        combined, stride = 0, 1
        for j, f in enumerate(self.factors):
            combined += idx[i + j] * stride
            stride *= f
        return idx[:i] + (combined,) + idx[i + k:]

    def apply_batch(self, idx: np.ndarray) -> np.ndarray:
        i, k = self.dim, len(self.factors)
        out = np.empty((idx.shape[0], idx.shape[1] - k + 1), dtype=idx.dtype)
        out[:, :i] = idx[:, :i]
        combined = np.zeros(idx.shape[0], dtype=idx.dtype)
        stride = 1
        for j, f in enumerate(self.factors):
            combined += idx[:, i + j] * stride
            stride *= f
        out[:, i] = combined
        out[:, i + 1:] = idx[:, i + k:]
        return out

    def spec(self) -> tuple:
        return ("decompose", self.dim, list(self.factors))

    def __str__(self) -> str:
        return f"decompose({self.dim}, {self.factors})"


_OP_NAMES = {"split", "merge", "swap", "slice", "decompose"}


@dataclasses.dataclass(frozen=True)
class Processor:
    """A concrete processor: coordinates in the root (physical) space.

    ``coords`` are the root-space coordinates; ``flat`` is the row-major
    linearization, which the JAX translation layer uses as the device id.
    """

    coords: tuple[int, ...]
    root_shape: tuple[int, ...]

    @property
    def flat(self) -> int:
        fid = 0
        for c, s in zip(self.coords, self.root_shape):
            fid = fid * s + c
        return fid

    @property
    def node(self) -> int:
        """First root coordinate (node / pod index in a 2-level machine)."""
        return self.coords[0]

    @property
    def proc(self) -> int:
        """Last root coordinate (processor-within-node in a 2-level machine)."""
        return self.coords[-1]

    def __iter__(self):
        return iter(self.coords)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Processor{self.coords}"


class ProcessorBatch:
    """A batch of processors: root coordinates for B points at once.

    ``coords`` has shape (B, root_ndim); ``flat`` is the (B,) row-major
    device-id vector — what the vectorized mapper evaluation consumes.
    """

    __slots__ = ("coords", "root_shape")

    def __init__(self, coords: np.ndarray, root_shape: tuple[int, ...]) -> None:
        self.coords = coords
        self.root_shape = root_shape

    @property
    def flat(self) -> np.ndarray:
        fid = np.zeros(self.coords.shape[0], dtype=np.int64)
        for j, s in enumerate(self.root_shape):
            fid = fid * s + self.coords[:, j]
        return fid

    def __len__(self) -> int:
        return self.coords.shape[0]

    def __getitem__(self, b: int) -> Processor:
        return Processor(tuple(int(c) for c in self.coords[b]), self.root_shape)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ProcessorBatch(n={len(self)}, root={self.root_shape})"


class ProcSpace:
    """An n-dimensional view of a machine's processors.

    ``shape`` -- extents of this (possibly transformed) view.
    ``ops``   -- the recorded transformation program mapping view indices
                 back to root coordinates (applied last-op-first).
    """

    def __init__(
        self,
        shape: Sequence[int],
        root_shape: Sequence[int] | None = None,
        ops: Sequence[Op] = (),
    ) -> None:
        self._shape = tuple(int(s) for s in shape)
        self._root_shape = (
            self._shape if root_shape is None
            else tuple(int(s) for s in root_shape)
        )
        if any(s <= 0 for s in self._shape):
            raise ValueError(f"non-positive extent in shape {self._shape}")
        self._ops = tuple(ops)

    # ------------------------------------------------------------------ views
    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape

    @property
    def root_shape(self) -> tuple[int, ...]:
        return self._root_shape

    @property
    def ops(self) -> tuple[Op, ...]:
        """The transformation IR: root shape + these ops define the space."""
        return self._ops

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> Tup:
        """Extents as a :class:`Tup` supporting elementwise arithmetic.

        Mirrors the paper's ``m.size`` (e.g. ``ipoint * m.size / ispace``).
        """
        return Tup(self._shape)

    @property
    def nprocs(self) -> int:
        return _prod(self._shape)

    def __len__(self) -> int:
        return self._shape[0]

    # ------------------------------------------------------------ index logic
    def _check_index(self, idx: Index) -> None:
        if len(idx) != self.ndim:
            raise IndexError(
                f"index {idx} has rank {len(idx)}, space has rank {self.ndim}"
            )
        for a, s in zip(idx, self._shape):
            if not 0 <= a < s:
                raise IndexError(f"index {idx} out of bounds for shape {self._shape}")

    def to_root(self, idx: Index) -> Index:
        idx = tuple(int(a) for a in idx)
        self._check_index(idx)
        for op in reversed(self._ops):
            idx = op.apply(idx)
        return idx

    def to_root_batch(self, idx: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`to_root`: (B, ndim) int array -> (B, root_ndim).

        Pure NumPy index arithmetic per recorded op — no per-point Python.
        """
        idx = np.asarray(idx, dtype=np.int64)
        if idx.ndim != 2 or idx.shape[1] != self.ndim:
            raise IndexError(
                f"batch index has shape {idx.shape}, expected (B, {self.ndim})"
            )
        shape = np.asarray(self._shape, dtype=np.int64)
        if ((idx < 0) | (idx >= shape)).any():
            raise IndexError(f"batch index out of bounds for shape {self._shape}")
        for op in reversed(self._ops):
            idx = op.apply_batch(idx)
        return idx

    def _batch_getitem(self, key: tuple) -> ProcessorBatch:
        """Index with a tuple of (B,) arrays / scalars -> ProcessorBatch."""
        cols = np.broadcast_arrays(
            *(as_index_component(np.asarray(k)) for k in key)
        )
        batch = np.stack([np.atleast_1d(c) for c in cols], axis=1)
        return ProcessorBatch(self.to_root_batch(batch), self._root_shape)

    def __getitem__(self, key):
        """Index the space.

        * full-rank int tuple (or ``m[*idx]`` unpacking / a :class:`Tup`)
          -> :class:`Processor` at those coordinates;
        * a ``slice`` -> :class:`Tup` of the sliced extents (the paper's
          ``m_4d[:-1]`` idiom, which coerces a space to its size tuple);
        * a single int on a 1-D space -> :class:`Processor`;
        * a single int on an n-D space -> that dimension's extent (the
          paper's ``pspace[dim]`` idiom in helper functions);
        * any component being a NumPy array (a batched :class:`Tup`
          coordinate) -> :class:`ProcessorBatch` over the whole batch.
        """
        if isinstance(key, slice):
            return Tup(self._shape[key])
        if isinstance(key, Tup):
            key = tuple(key)
        if isinstance(key, np.ndarray) and key.ndim == 1 and self.ndim == 1:
            key = (key,)
        if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
            if self.ndim == 1:
                key = (key,)
            else:
                return self._shape[key]
        if isinstance(key, tuple):
            if any(isinstance(k, np.ndarray) and k.ndim > 0 for k in key):
                return self._batch_getitem(key)
            idx = tuple(int(k) for k in key)
            root = self.to_root(idx)
            return Processor(root, self._root_shape)
        raise TypeError(f"cannot index ProcSpace with {key!r}")

    # ------------------------------------------------------------- primitives
    def _derive(self, shape: Sequence[int], op: Op) -> "ProcSpace":
        return ProcSpace(shape, self._root_shape, self._ops + (op,))

    def split(self, i: int, d: int) -> "ProcSpace":
        """Fig. 6: m' = m.split(i, d); shape (..., d, s_i/d, ...).

        Index semantics: ``m'[.., a_i, a_{i+1}, ..] = m[.., a_i + a_{i+1}*d, ..]``
        (the first new dim is the fast-varying component of the original dim).
        """
        s = self._shape
        if not 0 <= i < self.ndim:
            raise IndexError(f"split dim {i} out of range for rank {self.ndim}")
        if d <= 0 or s[i] % d != 0:
            raise ValueError(f"split factor {d} does not divide extent {s[i]}")
        new_shape = s[:i] + (d, s[i] // d) + s[i + 1:]
        return self._derive(new_shape, Split(i, d))

    def merge(self, p: int, q: int) -> "ProcSpace":
        """Fig. 6: fuse dims p and q into a single dim of extent s_p*s_q at p.

        Index semantics:
        ``m'[.., a_p, ..] = m[.., a_p mod s_p, .., floor(a_p / s_p), ..]``
        so that ``merge`` is the exact inverse of ``split`` (proved in the
        paper Sec. 3.3 and property-tested in tests/test_pspace.py).
        """
        if p == q:
            raise ValueError("merge requires two distinct dimensions")
        if p > q:
            # Normalize: merged dim lands at min(p, q); the paper writes p < q.
            raise ValueError("merge expects p < q (merged dim lands at p)")
        s = self._shape
        if not (0 <= p < self.ndim and 0 <= q < self.ndim):
            raise IndexError(f"merge dims ({p},{q}) out of range")
        sp, sq = s[p], s[q]
        new_shape = s[:p] + (sp * sq,) + s[p + 1:q] + s[q + 1:]
        return self._derive(new_shape, Merge(p, q, sp))

    def swap(self, p: int, q: int) -> "ProcSpace":
        """Fig. 6: exchange dims p and q."""
        s = list(self._shape)
        if not (0 <= p < self.ndim and 0 <= q < self.ndim):
            raise IndexError(f"swap dims ({p},{q}) out of range")
        s[p], s[q] = s[q], s[p]
        return self._derive(tuple(s), Swap(p, q))

    def slice(self, i: int, low: int, high: int) -> "ProcSpace":
        """Fig. 6: restrict dim i to the half-open range [low, high).

        Index semantics: ``m'[.., a_i, ..] = m[.., a_i + low, ..]``.
        """
        s = self._shape
        if not 0 <= i < self.ndim:
            raise IndexError(f"slice dim {i} out of range")
        if not (0 <= low < high <= s[i]):
            raise ValueError(f"slice bounds [{low},{high}) invalid for extent {s[i]}")
        new_shape = s[:i] + (high - low,) + s[i + 1:]
        return self._derive(new_shape, Slice(i, low, high))

    def decompose(self, i: int, lengths, *, objective=None, halo=None) -> "ProcSpace":
        """Sec. 4: optimally factor dim i against iteration extents ``lengths``.

        Splits extent d_i into k = len(lengths) factors (d_1..d_k) minimizing
        the communication-volume objective  sum_m d_m / l_m  (or a caller-
        supplied objective, e.g. anisotropic halo weights per Sec. 7.2),
        then applies the equivalent sequence of ``split`` transformations:

            m_{n+1} = m_n.split(i + n - 1, d_{i_n})  for 1 <= n < k.
        """
        from repro_torch.core.decompose import optimal_factorization

        lengths = tuple(int(x) for x in lengths)
        factors = optimal_factorization(
            self._shape[i], lengths, objective=objective, halo=halo
        )
        return self.decompose_with(i, factors)

    def decompose_with(self, i: int, factors: Sequence[int]) -> "ProcSpace":
        """Apply a pre-computed factorization (the split-sequence expansion,
        recorded as a single :class:`Decompose` op)."""
        factors = tuple(int(f) for f in factors)
        if not 0 <= i < self.ndim:
            raise IndexError(f"decompose dim {i} out of range")
        if _prod(factors) != self._shape[i]:
            raise ValueError(
                f"factors {factors} do not multiply to extent {self._shape[i]}"
            )
        if len(factors) <= 1:
            return self
        s = self._shape
        new_shape = s[:i] + factors + s[i + 1:]
        return self._derive(new_shape, Decompose(i, factors))

    # ------------------------------------------------------- IR introspection
    def describe(self) -> str:
        """The transformation program as text, e.g.
        ``root(2, 4).merge(0, 1).split(0, 4)``."""
        root = ", ".join(str(s) for s in self._root_shape)
        return f"root({root})" + "".join(f".{op}" for op in self._ops)

    def to_ir(self) -> dict:
        """JSON-able IR: ``{"root_shape": [...], "ops": [[name, ...], ...]}``."""
        return {
            "root_shape": list(self._root_shape),
            "ops": [list(op.spec()) for op in self._ops],
        }

    @classmethod
    def from_ir(cls, ir: dict) -> "ProcSpace":
        """Rebuild a space by replaying a serialized transformation program."""
        space = cls(ir["root_shape"])
        for op in ir["ops"]:
            name, *args = op
            if name not in _OP_NAMES:
                raise ValueError(f"unknown IR op {name!r}")
            if name == "decompose":
                space = space.decompose_with(args[0], tuple(args[1]))
            else:
                space = getattr(space, name)(*args)
        return space

    # ------------------------------------------------------------------ misc
    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"ProcSpace(shape={self._shape}, root={self._root_shape}, "
            f"ops={len(self._ops)})"
        )
