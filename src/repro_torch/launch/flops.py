"""Loop-aware FLOP and byte count of one step on the meta device.

The port's counterpart of ``repro.launch.hlo_cost`` and
``hlo_analysis``. A torch program has no HLO text, so the step runs on
empty meta tensors (``launch/specs.py``) under a dispatch mode that sees
every operator, including the backward's and the remat recompute's:

  * flops: what ``hlo_cost.analyze`` counts, 2 x out_elems x contraction
    of every matrix product (``torch.utils.flop_counter``'s formulas for
    ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and convolutions); elementwise
    work is excluded, as there;
  * bytes_unfused: the input and output bytes of every operator that is
    not a view, each tensor once per operator. XLA's fused "bytes
    accessed" has no counterpart in an eager program, so this overstates
    the traffic: a memory term built on it is an upper bound;
  * collective bytes: on a mesh on a process group (``core/world.py``),
    the output bytes of every collective this rank issues, by the
    reference's five kinds (``hlo_analysis.py``'s per-device convention):
    those of ``core/spmd.py``'s bodies and those DTensor inserts to
    reshard. 0 on one card.

Under DTensor (a cell on a fake group of 256 or 512 ranks) the count is
one rank's: an operator on DTensors is not counted itself (its shapes
are global); the counter steps aside (``NotImplemented``), DTensor runs
it as local operators on this rank's blocks and the collectives its
redistributions need, and those come back through the counter. An
exchange that sends to one rank and receives from one is a
``collective-permute`` (``spmd.ppermute``); DTensor's own reshard of one
sharded dim into another is ``all-to-all``.

Loop-aware, as the reference's count is: a loop over time, chunks or
microbatches runs through ``models/loops.py``, which on the meta device
runs a few trips, one of them standing for many. The counter multiplies
that trip's operators by the trips it stands for, and those of its
backward too: an autograd node created inside such a trip is remembered
by its sequence number, and the operators run while the backward
executes it take the trip's multiplier. Operators run with grad on
inside a backward are a remat recompute, a forward again, and take the
multiplier of the loop they run in.

The count always runs the plain route (``use_kernel=False``), the
reference cell's default: a meta tensor sent to a CUDA kernel's wrapper
raises, and a counter could not see inside a kernel anyway.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from fractions import Fraction
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import loops
from repro_torch.models.config import ModelConfig, ShapeConfig

_aten = torch.ops.aten
# Operators that neither read nor write a tensor's data: they make an
# empty one, detach or alias it, or read a scalar's value.
_NO_TRAFFIC = {_aten.detach, _aten.alias, _aten.empty, _aten.empty_strided,
               _aten.empty_like, _aten.new_empty, _aten.lift_fresh,
               _aten._local_scalar_dense,
               getattr(torch.ops._c10d_functional, "wait_tensor", None)}


# Torch versions on which the backward's attribution below was checked
# (tests/test_torch_flops.py: the folded count equals the unrolled one).
AUTOGRAD_CHECKED_ON = ("2.11", "2.13")


def _autograd_seq(next_node: bool = False) -> int | None:
    """The one use of autograd's private internals: the sequence number of
    the node the backward runs now (None outside a backward), or with
    ``next_node`` the number the next node made gets, less one. Raises if
    this torch lacks them, so that a count never silently loses the
    backward's multipliers."""
    try:
        if next_node:
            with torch.enable_grad():
                probe = torch.empty((), device="meta", requires_grad=True).view(())
            node = probe.grad_fn
        else:
            node = torch._C._current_autograd_node()
        return None if node is None else int(node._sequence_nr())
    except (AttributeError, TypeError) as e:
        raise RuntimeError(
            f"the loop-aware count attributes a folded trip's backward through "
            f"torch._C._current_autograd_node() and Node._sequence_nr(), checked "
            f"on torch {', '.join(AUTOGRAD_CHECKED_ON)}; torch {torch.__version__} "
            f"lacks them ({e}): count with loop_aware=False") from e


@dataclasses.dataclass
class Costs:
    """One step's count (the fields of ``hlo_cost.Costs``, with the bytes
    named for what they are), and the seconds the count took."""

    flops: float = 0.0
    bytes_unfused: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(default_factory=dict)
    collective_count_by_kind: dict = dataclasses.field(default_factory=dict)
    # (kind, output shape, dtype) -> [firings, bytes of one firing]
    collective_ops: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    # The step's arguments (weights, optimizer state, batch or cache): a
    # lower bound on the memory the step holds; on a mesh, this rank's.
    argument_bytes: float = 0.0
    # On a mesh (launch/steps.py::Cell.count): this rank's output bytes,
    # and those of outputs that are arguments updated in place.
    output_bytes: float = 0.0
    alias_bytes: float = 0.0


# The reference's five kinds (hlo_analysis.COLLECTIVES), by the operator
# that issues them: torch.distributed's functional collectives, and
# DTensor's reshard of one sharded dim into another.
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd", "_dtensor")
_KIND_OF = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter",
            "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}


def _collective_kind(func, args) -> str | None:
    """The kind of collective ``func`` is, None for any other operator
    (and for bookkeeping such as ``wait_tensor``, which moves nothing);
    raises on a collective outside the five kinds."""
    ns, _, name = func.name().partition("::")
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    name = name.split(".")[0]
    kind = _KIND_OF.get(name)
    if kind is None:
        if any(w in name for w in ("gather", "reduce", "scatter", "broadcast",
                                   "all", "permute")):
            raise ValueError(f"collective {func.name()} is none of {COLLECTIVES}")
        return None                  # wait_tensor and other bookkeeping
    if name == "all_to_all_single":
        out_splits, in_splits = args[1], args[2]
        if len(out_splits) > 1 and sum(1 for n in out_splits if n) <= 1 \
                and sum(1 for n in in_splits if n) <= 1:
            kind = "collective-permute"
    return kind


@dataclasses.dataclass
class CollectiveStats:
    """Per-device collective output bytes and firings by kind: the
    reference's ``hlo_analysis.CollectiveStats``."""

    bytes_by_kind: dict
    count_by_kind: dict

    @classmethod
    def of(cls, costs: Costs) -> "CollectiveStats":
        return cls(dict(costs.collective_by_kind), dict(costs.collective_count_by_kind))

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> str:
        rows = [
            f"  {k:20s} n={self.count_by_kind[k]:6.0f}  "
            f"{self.bytes_by_kind[k] / 2**20:12.2f} MiB"
            for k in sorted(self.bytes_by_kind)
        ]
        rows.append(f"  {'TOTAL':20s}         {self.total_bytes / 2**20:12.2f} MiB")
        return "\n".join(rows)


def dominant_ops(costs: Costs, top: int | None = 8) -> list[tuple[str, float]]:
    """The largest single collectives of a count (``hlo_analysis.
    dominant_ops``): ("kind shape dtype x firings", bytes of one firing),
    largest first; all of them with ``top`` None."""
    rows = [(f"{kind} {list(shape)} {str(dtype).replace('torch.', '')} "
             f"x {float(n):g}", float(b))
            for (kind, shape, dtype), (n, b) in costs.collective_ops.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def nbytes(tree) -> int:
    """Bytes of the tensors in nested dicts, lists, tuples and dataclasses
    (of a DTensor, its block on this rank)."""
    if isinstance(tree, torch.Tensor):
        tree = getattr(tree, "_local_tensor", tree)
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    return sum(nbytes(x) for x in tree) if isinstance(tree, (list, tuple)) else 0


class Counter(TorchDispatchMode):
    """Sums flops and unfused bytes of the operators it sees, each times
    the multiplier of the folded loops it runs in (``repeat``)."""

    def __init__(self):
        super().__init__()
        self.flops = Fraction(0)
        self.bytes = Fraction(0)
        self._scale = [Fraction(1)]
        # [first, last, multiplier]: the sequence numbers of the autograd
        # nodes made inside one folded trip; last is None while the trip
        # runs (a microbatch's backward runs inside its trip).
        self._spans: list[list] = []
        self._quiet = False
        self.coll_bytes: dict[str, Fraction] = {}
        self.coll_count: dict[str, Fraction] = {}
        self.coll_ops: dict[tuple, list] = {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        self._dtensor, self._fake = DTensor, FakeTensor

    def _next_seq(self) -> int:
        """The sequence number the next autograd node gets, less one."""
        self._quiet = True
        try:
            return _autograd_seq(next_node=True)
        finally:
            self._quiet = False

    @contextlib.contextmanager
    def repeat(self, times: Fraction | int):
        """Count what runs inside ``times`` over (times the enclosing
        folds' multiplier), its backward included."""
        scale = self._scale[-1] * times
        span = [self._next_seq(), None, scale] if torch.is_grad_enabled() else None
        if span is not None:
            self._spans.append(span)
        self._scale.append(scale)
        try:
            yield
        finally:
            self._scale.pop()
            if span is not None:
                span[1] = self._next_seq()

    def _multiplier(self) -> Fraction:
        """In a backward (a node runs with grad off) the folded trip that
        made the node decides; anywhere else, the trips running now. With
        no fold begun (an unrolled count) every multiplier is 1."""
        if not self._spans and len(self._scale) == 1:
            return self._scale[-1]
        seq = None if torch.is_grad_enabled() else _autograd_seq()
        if seq is None:
            return self._scale[-1]
        inner = None
        for first, last, scale in self._spans:
            if first < seq and (last is None or seq < last) \
                    and (inner is None or first > inner[0]):
                inner = (first, scale)
        return inner[1] if inner else Fraction(1)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            # DTensor turns it into local operators and collectives, which
            # come back here; the global operator is not counted.
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet or any(issubclass(t, self._fake) for t in types):
            # (DTensor infers a global output's shape by running the
            # operator on fake tensors: no work of this rank's)
            return out
        kind = _collective_kind(func, args)
        if kind is not None:
            mult = self._multiplier()
            b = nbytes(out)
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + mult * b
            self.coll_count[kind] = self.coll_count.get(kind, 0) + mult
            key = (kind, tuple(out.shape), out.dtype)
            self.coll_ops.setdefault(key, [Fraction(0), b])[0] += mult
        packet = func._overloadpacket
        mult = None
        if packet in flop_registry:
            mult = self._multiplier()
            self.flops += mult * int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and packet not in _NO_TRAFFIC:
            mult = self._multiplier() if mult is None else mult
            self.bytes += mult * (nbytes((args, kwargs)) + nbytes(out))
        return out


def count(fn: Callable, *args, loop_aware: bool = True) -> Costs:
    """Run ``fn(*args)`` (meta tensors) under a ``Counter``. With
    ``loop_aware`` the loops of ``models/loops.py`` fold, a few trips
    standing for all of theirs; without, every trip runs and is counted
    (the check of the fold: both give the same FLOPs)."""
    counter = Counter()
    token = loops.COUNTER.set(counter) if loop_aware else None
    t0 = time.perf_counter()
    try:
        with counter:
            fn(*args)
    finally:
        if token is not None:
            loops.COUNTER.reset(token)
    return Costs(flops=float(counter.flops), bytes_unfused=float(counter.bytes),
                 collective_bytes=float(sum(counter.coll_bytes.values())),
                 collective_by_kind={k: float(v) for k, v in counter.coll_bytes.items()},
                 collective_count_by_kind={k: float(v)
                                           for k, v in counter.coll_count.items()},
                 collective_ops=counter.coll_ops,
                 seconds=time.perf_counter() - t0)


def step_args(cfg: ModelConfig, shape: ShapeConfig):
    """The cell's step and its meta arguments: the train step on an
    abstract train state and batch, the plain prefill step, or one decode
    step at the cache's last position (the port's decode step takes the
    position as an int; its work does not depend on it)."""
    from repro_torch.launch import specs, steps
    from repro_torch.models.params import abstract_params
    from repro_torch.models.registry import build
    from repro_torch.training.loop import TrainState
    from repro_torch.training.optimizer import AdamWState

    model = build(cfg)
    params = abstract_params(model.schema)
    if shape.kind == "train":
        moments = lambda: abstract_params(model.schema, torch.float32)  # noqa: E731
        state = TrainState(params, AdamWState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            mu=moments(), nu=moments()))
        return steps.make_train_step(model, shape), (state, specs.batch_specs(cfg, shape))
    if shape.kind == "prefill":
        return (steps.make_prefill_step(model, use_kernel=False),
                (params, specs.prefill_specs(cfg, shape)["inputs"]))
    d = specs.decode_specs(cfg, shape)
    return steps.make_serve_step(model), (params, d["cache"], shape.seq_len - 1, d["token"])


def count_cell(cfg: ModelConfig, shape: ShapeConfig) -> Costs:
    """The count of one (arch x shape) cell at the shape's global batch on
    one card: the train step (loss, gradient through remat, AdamW, with
    ``choose_microbatches``' accumulation), the prefill or a decode step."""
    step, args = step_args(cfg, shape)
    costs = count(step, *args)
    costs.argument_bytes = float(nbytes(args))
    return costs
