"""The ``decompose`` primitive's solver (paper Sec. 4) and baselines.

Problem: factor a processor count ``d`` into k ordered natural factors
(d_1, .., d_k), one per iteration-space dimension (l_1, .., l_k), minimizing
communication volume. Paper Sec. 4.2 reduces halo (nearest-neighbour)
communication to the objective

    minimize  sum_m  d_m / l_m        s.t.  prod_m d_m = d.

Sec. 7.2 generalizes to anisotropic halos (weights h_m) and transposes
(all-to-all along a subset of dims); only the objective changes, the same
enumerator applies.

The enumerator (Sec. 4.3) is exhaustive and therefore *optimal*: for
d = p_1^a_1 * ... * p_t^a_t it enumerates, per prime, all stars-and-bars
placements of the a_j copies over the k dims, and takes the Cartesian
product — prod_j C(a_j + k - 1, k - 1) candidates, tiny in practice.

``greedy_factorization`` is Algorithm 1 of the paper (the Chapel-style
heuristic): iteration-space *oblivious*, provably suboptimal (Sec. 4.1).
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Callable, Iterable, Iterator, Sequence


# --------------------------------------------------------------------- primes
def prime_factorization(d: int) -> list[int]:
    """Sorted (ascending) list of prime factors of ``d`` with multiplicity."""
    if d < 1:
        raise ValueError(f"cannot factor {d}")
    out: list[int] = []
    n = d
    f = 2
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 1 if f == 2 else 2
    if n > 1:
        out.append(n)
    return out


def _compositions(total: int, k: int) -> Iterator[tuple[int, ...]]:
    """All non-negative integer solutions to x_1 + ... + x_k = total."""
    if k == 1:
        yield (total,)
        return
    for first in range(total + 1):
        for rest in _compositions(total - first, k - 1):
            yield (first,) + rest


def enumerate_factorizations(d: int, k: int) -> Iterator[tuple[int, ...]]:
    """All ordered k-tuples of naturals whose product is ``d`` (Sec. 4.3)."""
    primes = prime_factorization(d) if d > 1 else []
    groups: dict[int, int] = {}
    for p in primes:
        groups[p] = groups.get(p, 0) + 1
    per_prime = [
        [(p, comp) for comp in _compositions(a, k)] for p, a in sorted(groups.items())
    ]
    if not per_prime:
        yield (1,) * k
        return
    for combo in itertools.product(*per_prime):
        factors = [1] * k
        for p, comp in combo:
            for dim, exp in enumerate(comp):
                factors[dim] *= p ** exp
        yield tuple(factors)


def count_factorizations(d: int, k: int) -> int:
    """Closed form prod_j C(a_j + k - 1, k - 1) — used in tests/docs."""
    primes = prime_factorization(d) if d > 1 else []
    groups: dict[int, int] = {}
    for p in primes:
        groups[p] = groups.get(p, 0) + 1
    out = 1
    for a in groups.values():
        out *= math.comb(a + k - 1, k - 1)
    return out


# ----------------------------------------------------------------- objectives
def halo_objective(lengths: Sequence[int], halo: Sequence[float] | None = None
                   ) -> Callable[[Sequence[int]], float]:
    """Paper objective: sum_m h_m * d_m / l_m (isotropic when h == 1).

    Derivation (Sec. 4.2 / 7.2.1): communication volume
    V = (sum_n h_n / w_n) * prod(l) with w_n = l_n / d_n, so minimizing V
    is minimizing sum_n h_n * d_n / l_n.
    """
    h = tuple(halo) if halo is not None else (1.0,) * len(lengths)
    ls = tuple(float(x) for x in lengths)

    def obj(factors: Sequence[int]) -> float:
        return sum(hm * dm / lm for hm, dm, lm in zip(h, factors, ls))

    return obj


def transpose_objective(
    lengths: Sequence[int],
    transpose_dims: Iterable[int],
    halo: Sequence[float] | None = None,
) -> Callable[[Sequence[int]], float]:
    """Sec. 7.2.2: halo volume + all-to-all volume along ``transpose_dims``.

    V_total = V_halo + sum_{n in T} (1 - 1/d_n) * prod(w) * d
    with prod(w) * d = prod(l) constant, so the transpose term reduces to
    prod(l) * sum_{n in T} (1 - 1/d_n). We keep absolute volumes so mixed
    objectives weigh halo and transpose terms consistently.
    """
    tset = set(transpose_dims)
    ls = tuple(float(x) for x in lengths)
    h = tuple(halo) if halo is not None else (1.0,) * len(lengths)
    lprod = math.prod(ls)

    def obj(factors: Sequence[int]) -> float:
        halo_v = lprod * sum(
            hm * dm / lm for hm, dm, lm in zip(h, factors, ls)
        )
        transpose_v = lprod * sum(
            (1.0 - 1.0 / factors[n]) for n in tset
        )
        return halo_v + transpose_v

    return obj


# -------------------------------------------------------------------- solvers
def optimal_factorization(
    d: int,
    lengths: Sequence[int],
    *,
    objective: Callable[[Sequence[int]], float] | None = None,
    halo: Sequence[float] | None = None,
    require_divisible: bool = False,
) -> tuple[int, ...]:
    """The ``decompose`` solver: exhaustive, optimal (Sec. 4.3).

    ``objective``: maps a candidate factor tuple to a cost (default: the
    paper's halo objective over ``lengths``, optionally anisotropic via
    ``halo`` weights). Ties break toward factorizations that divide the
    iteration extents evenly, then lexicographically for determinism.

    ``require_divisible``: restrict to factorizations where every d_m
    divides l_m (the paper's integrality constraint l_m/w_m in N); if no
    candidate satisfies it, falls back to the unconstrained optimum.
    """
    lengths = tuple(int(x) for x in lengths)
    k = len(lengths)
    if k == 0:
        raise ValueError("decompose needs at least one iteration dimension")
    obj = objective if objective is not None else halo_objective(lengths, halo)

    def divisible(f: Sequence[int]) -> bool:
        return all(l % dm == 0 for l, dm in zip(lengths, f))

    best: tuple[float, int, tuple[int, ...]] | None = None
    best_div: tuple[float, int, tuple[int, ...]] | None = None
    for f in enumerate_factorizations(d, k):
        key = (float(obj(f)), 0 if divisible(f) else 1, f)
        if best is None or key < best:
            best = key
        if divisible(f) and (best_div is None or key < best_div):
            best_div = key
    assert best is not None
    if require_divisible and best_div is not None:
        return best_div[2]
    return best[2]


def greedy_factorization(d: int, k: int) -> tuple[int, ...]:
    """Algorithm 1 of the paper — the *suboptimal* baseline heuristic.

    Iteration-space-oblivious: assigns each prime factor (ascending) to the
    dimension with the smallest running product, then sorts descending.
    """
    primes = prime_factorization(d) if d > 1 else []
    factors = [1] * k
    for p in primes:
        j = min(range(k), key=lambda i: factors[i])
        factors[j] *= p
    factors.sort(reverse=True)
    return tuple(factors)


def greedy_workload_factorization(d: int, lengths: Sequence[int]) -> tuple[int, ...]:
    """The greedy strawman of Sec. 4.3's closing example: assign primes to
    minimize the max spread of the workload vector at each step. Suboptimal
    (e.g. d=72, l=(8,9) -> workload (4/3, 3/4) vs optimal (1,1))."""
    primes = sorted(prime_factorization(d) if d > 1 else [], reverse=True)
    k = len(lengths)
    factors = [1] * k

    def spread(fs: Sequence[int]) -> float:
        w = [l / f for l, f in zip(lengths, fs)]
        return max(w) - min(w)

    for p in primes:
        best_j, best_s = 0, None
        for j in range(k):
            trial = list(factors)
            trial[j] *= p
            s = spread(trial)
            if best_s is None or s < best_s:
                best_j, best_s = j, s
        factors[best_j] *= p
    return tuple(factors)


@functools.lru_cache(maxsize=4096)
def cached_optimal(d: int, lengths: tuple[int, ...],
                   halo: tuple[float, ...] | None = None,
                   require_divisible: bool = False) -> tuple[int, ...]:
    """Memoized entry point for hot paths (grid planning in the launchers).

    ``require_divisible`` honors the paper's integrality constraint
    (every d_m divides l_m) — the shard_map launchers need it because XLA
    shards must tile the array evenly; falls back to the unconstrained
    optimum when no divisible factorization exists.
    """
    return optimal_factorization(
        d, lengths, halo=halo, require_divisible=require_divisible
    )
