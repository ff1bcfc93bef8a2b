"""Python loops whose trip count is known before they run.

Where the reference scans (``lax.scan`` over time, over chunks, over
microbatches), the port runs a Python loop, and every trip does the same
work on tensors of the same shapes. XLA keeps a scan as one while loop,
so the reference's cost model (``repro.launch.hlo_cost``) counts its body
once and multiplies it by the trip count. A count of the port's eager
program would otherwise pass every trip through the counter: a 32768-step
time loop in each of 32 layers.

``trips(n, like)`` is ``range(n)``. While a loop-aware count is on
(``repro_torch.launch.flops``), ``like`` lies on the meta device and n is
3 or more, it runs three trips, and the count takes the middle one n - 2
times, together with its backward. The first and the last trip run on
their own because their backward can differ from the others': the first
may start from a carry that needs no gradient, and the last one's carry
may go nowhere. Every middle trip has a carry in and a carry out, so each
does the same forward and backward work. ``trips(n, like, times)`` runs
one trip standing for ``times``: for a loop whose trips all do the same
counted work, first and last alike, and whose trip count varies with an
enclosing folded loop's index (``times`` is then the mean). ``stack``
gives back a folded loop's per-trip outputs at their whole length. On
any real device, or with no count on, the loop is left as it is.
"""
from __future__ import annotations

import contextvars
from fractions import Fraction
from typing import Iterable

import torch

# The count that folds loops, or None: set by repro_torch.launch.flops
# for the length of one count.
COUNTER: contextvars.ContextVar = contextvars.ContextVar("loop_counter", default=None)


def trips(n: int, like: torch.Tensor, times: Fraction | int | None = None
          ) -> Iterable[int]:
    """``range(n)``, or, while a loop-aware count runs on the meta device,
    trips 0, 1 and 2 with trip 1 counted n - 2 times (``times`` None, n at
    least 3), or trip 0 counted ``times`` times."""
    counter = COUNTER.get()
    if counter is None or like.device.type != "meta" or n == 0:
        return range(n)
    if times is not None:
        return _one_trip(counter, times)
    return range(n) if n < 3 else _three_trips(counter, n)


def _one_trip(counter, times):
    with counter.repeat(times):
        yield 0


def _three_trips(counter, n: int):
    yield 0
    with counter.repeat(n - 2):
        yield 1
    yield 2


def stack(items: list, n: int, dim: int = 0) -> torch.Tensor:
    """``torch.stack`` of a loop's per-trip outputs at its trip count
    ``n``. After a folded loop, the trip that stood for many stands for
    them here as an expanded view, so no list of n tensors is built."""
    if len(items) == n:
        return torch.stack(items, dim)
    parts = [x.unsqueeze(dim) for x in items]
    shape = list(parts[len(parts) // 2].shape)
    shape[dim] = n - len(parts) + 1
    parts[len(parts) // 2] = parts[len(parts) // 2].expand(shape)
    return torch.cat(parts, dim)
