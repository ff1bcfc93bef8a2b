"""Step functions of the launchers and the production-mesh cell (the port
of ``repro.launch.steps``).

The reference builds a lowering cell per (arch x shape): a step callable
plus abstract arguments and shardings for XLA. On one card the step
callables are what is left: the abstract arguments are
``launch/specs.py``'s meta tensors, and the dry run
(``launch/dryrun.py``) counts a step on them in place of lowering it. On
a production mesh ``make_cell`` builds the whole cell (``Cell``): its
arguments are meta DTensors on a process group placed by
``launch/policy.py``'s plan, ``Cell.count`` counts one rank's share and
``Cell.run`` runs it on a device, on seeded filler or, on a real group,
on this rank's blocks of whole values (``Cell.place``), whose outputs
``Cell.gather`` makes whole. ``mesh_settings`` is the one place the
model's mesh switches (sequence sharding, the layer barrier, the MoE
groups) are set for a cell. The train step keeps the reference's
gradient accumulation, with the accumulation factor from
``choose_microbatches``; its loop over microbatches goes through
``models/loops.py``, so the count takes one microbatch for all.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable

import torch

from repro_torch.core.spmd import P as spmd_P
from repro_torch.models import loops
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch import tracing
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.loop import TrainState, value_and_grad


@contextlib.contextmanager
def mesh_settings(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
                  mode: str | None = None, seq_shard: bool = True):
    """The mesh settings of the reference's ``make_cell`` for one cell,
    restored on exit: sequence sharding over 'model' for train and prefill
    shapes whose length divides by 16 (unless ``seq_shard`` is off), the
    layer barrier under FSDP, and MoE dispatch groups = gcd(data shards,
    tokens per step). ``mesh`` is a ``spmd.Mesh`` (None: one card, one
    data shard); it is put in scope for the block. Yields the sharding
    mode: ``mode``, else ``policy.choose_mode(cfg)``."""
    from repro_torch.core import spmd
    from repro_torch.launch.policy import choose_mode
    from repro_torch.models import sharding as shd

    saved = (shd.seq_axis(), shd._LAYER_BARRIER, shd.moe_groups())
    mode = mode or choose_mode(cfg)
    shd.set_sequence_sharding(
        "model" if (seq_shard and shape.kind in ("train", "prefill")
                    and shape.seq_len % 16 == 0) else None)
    shd.set_layer_barrier(mode == "fsdp")
    dp_total, _ = mesh_dims(mesh)
    tokens_per_step = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    shd.set_moe_groups(math.gcd(dp_total, tokens_per_step))
    try:
        with spmd.use_mesh(mesh):
            yield mode
    finally:
        shd.set_sequence_sharding(saved[0])
        shd.set_layer_barrier(saved[1])
        shd.set_moe_groups(saved[2])


def mesh_dims(mesh) -> tuple[int, int]:
    """A mesh's data-parallel size (its 'pod' and 'data' axes) and its
    model axis size; (1, 1) for no mesh (one card)."""
    if mesh is None:
        return 1, 1
    dp = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            dp *= mesh.axis_size(ax)
    return dp, mesh.axis_size("model") if "model" in mesh.axis_names else 1


def choose_microbatches(cfg: ModelConfig, shape: ShapeConfig, dp: int = 1,
                        model_size: int = 1) -> int:
    """Smallest accumulation factor whose live activation estimate fits.

    Estimate per device: saved residuals (seq-sharded when SP is on) +
    the cross-entropy logits block (vocab-sharded). ``dp`` and
    ``model_size`` are the mesh's data-parallel and model axes (1 and 1
    on one card). ``knobs.active().microbatch``, when set, decides.
    """
    from repro_torch.launch.knobs import active

    if active().microbatch:
        return active().microbatch
    b_dev = max(shape.global_batch // max(dp, 1), 1)
    sp = 16 if shape.seq_len % 16 == 0 else 1
    budget = 4.5e9
    for n in (1, 2, 4, 8, 16):
        if shape.global_batch % (dp * n):
            continue
        bd = b_dev / n
        resid = cfg.n_layers * bd * shape.seq_len * cfg.d_model * 2 / sp
        logits = bd * shape.seq_len * cfg.padded_vocab * 6 / max(model_size, 1)
        moe = 0.0
        if cfg.n_experts:
            # dispatch/recv/expert-act stashes per MoE layer (backward)
            n_moe = cfg.n_layers - cfg.first_dense_layers
            moe = 3.0 * n_moe * bd * shape.seq_len * cfg.topk \
                * cfg.d_model * 2 / max(model_size, 1)
        if resid + logits + moe < budget:
            return n
    return 16 if shape.global_batch % (dp * 16) == 0 else 1


def make_train_step(model, shape: ShapeConfig,
                    opt_cfg: opt_mod.AdamWConfig = opt_mod.AdamWConfig(total_steps=10000),
                    n_micro: int | None = None) -> Callable:
    """``train_step(state, batch)`` -> (state, metrics): the train branch
    of the reference's ``make_cell``. With ``n_micro`` > 1 (default:
    ``choose_microbatches`` on one card) the batch is split into that many
    microbatches along its leading axis, and the loss (divided by
    ``n_micro``) and the fp32 gradient sums (each gradient divided by
    ``n_micro``) accumulate over them before one AdamW update; only one
    microbatch's activations are live at a time. The plain path, with
    ``remat``, as the reference's."""
    if n_micro is None:
        n_micro = choose_microbatches(model.cfg, shape)

    def loss_of(batch):
        return lambda p: model.loss(p, batch)

    def train_step(state: TrainState, batch):
        if n_micro == 1:
            loss, grads = value_and_grad(loss_of(batch), state.params)
        else:
            micro = {k: shd.microbatches(v, n_micro) for k, v in batch.items()}
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             state.params)
            acc = tree_leaves(grads)
            for i in loops.trips(n_micro, next(iter(batch.values()))):
                mb = {k: v[i] for k, v in micro.items()}
                mloss, g = value_and_grad(loss_of(mb), state.params)
                for a, b in zip(acc, tree_leaves(g)):
                    a.add_(b.to(torch.float32) / n_micro)
                loss = loss + mloss / n_micro
        params, opt_state, metrics = opt_mod.update(
            opt_cfg, grads, state.opt, state.params)
        return TrainState(params, opt_state, None), {"loss": loss, **metrics}

    return train_step


def make_prefill_step(model, use_kernel: bool = True) -> Callable:
    """``prefill_step(params, inputs)`` -> last-position logits (B,1,V):
    the serving prefill, with ``use_kernel`` through the model family's
    kernels: flash-attention for the dense and MoE decoders (qwen2-moe at
    head dim 128), flash-attention and selective scan for Hymba, WKV6 for
    RWKV-6. MLA (deepseek-v2-lite) has no kernel route, as in the
    reference: it serves with ``use_kernel=False``, and with ``True`` the
    step raises a ``ValueError``."""

    @torch.no_grad()
    def prefill_step(params, inputs):
        with tracing.step("step.prefill"):
            return model.last_logits(params, inputs, use_kernel=use_kernel)

    return prefill_step


def make_serve_step(model) -> Callable:
    """``serve_step(params, cache, pos, token)`` -> (logits, cache): one
    decode step; the cache is updated in place."""

    @torch.no_grad()
    def serve_step(params, cache, pos, token):
        with tracing.step("step.decode"):
            return model.decode_step(params, cache, pos, token)

    return serve_step


# ------------------------------------------------- production-mesh cells
@dataclasses.dataclass
class Cell:
    """One (arch x shape) cell on a mesh on a process group (the
    reference's ``make_cell`` result): the step, its arguments as meta
    DTensors placed by the plan (this rank's blocks), the in and out
    shardings, the plan and the mesh. ``count`` takes the place of
    ``lower().compile()``; ``run`` runs this rank's share once on a
    device."""

    arch: str
    cfg: ModelConfig
    shape: ShapeConfig
    step_fn: Callable
    abstract_args: tuple
    in_shardings: Any
    out_shardings: Any
    plan: Any
    mesh: Any
    seq_shard: bool = True
    n_micro: int = 1

    @contextlib.contextmanager
    def _settings(self, mesh):
        from torch.distributed.tensor.experimental import implicit_replication

        with mesh_settings(self.cfg, self.shape, mesh, mode=self.plan.mode,
                           seq_shard=self.seq_shard), implicit_replication():
            yield

    def _call(self, args):
        """The step on ``args``, its outputs redistributed to the out
        shardings (the reference's ``out_shardings``)."""
        return _place(self.step_fn(*args), self.out_shardings)

    def count(self):
        """This rank's loop-aware count of the step (``launch/flops.py``)
        with its argument, output and aliased-output bytes."""
        from repro_torch.launch import flops

        held = {}

        def step(*args):
            held["out"] = self._call(args)

        with self._settings(self.mesh):
            costs = flops.count(step, *self.abstract_args)
        costs.argument_bytes = float(_spec_bytes(self.abstract_args, self.in_shardings))
        costs.output_bytes, costs.alias_bytes = _output_bytes(held["out"],
                                                              self.abstract_args)
        return costs

    def place(self, make, device=None) -> tuple:
        """The step's arguments as DTensors on this rank's blocks, from
        whole values: ``make(path, like)`` gives the whole leaf at ``path``
        (``ARG_NAMES`` joined with the tree's keys by '/'; the decode
        position an int) of ``like``'s global shape and dtype
        (:func:`seeded_values`). Leaf by leaf, the whole value is made, cut
        to this rank's block by its ``NamedSharding.distribute`` on
        ``device`` (default: the mesh's) and freed, so no process holds
        the whole tree; on a folded mesh a ZeRO-1 moment is cut as its
        DTensor is (``_on_fold``)."""
        from torch.distributed.tensor import DTensor

        dev = torch.device(device) if device is not None else self.mesh.device
        mesh = dataclasses.replace(self.mesh, device=dev)

        def one(path, x, sh):
            if not isinstance(x, DTensor):
                return make(path, x) if path == "pos" else x
            whole = torch.as_tensor(make(path, x))
            if tuple(whole.shape) != tuple(x.shape) or whole.dtype != x.dtype:
                raise ValueError(f"{path}: whole value {tuple(whole.shape)} "
                                 f"{whole.dtype}, the cell takes {tuple(x.shape)} {x.dtype}")
            block = dataclasses.replace(sh, mesh=mesh).distribute(whole.to(dev))
            del whole
            return block

        return tuple(_tree_at(one, name, a, sh) for name, a, sh in
                     zip(ARG_NAMES[self.shape.kind], self.abstract_args,
                         self._arg_shardings()))

    def whole(self, make, device) -> tuple:
        """The step's arguments as whole plain tensors on ``device`` (the
        one-process twin's), from the same ``make`` as :meth:`place`."""
        def one(path, x):
            if path == "pos":
                return make(path, x)
            return torch.as_tensor(make(path, x)).to(device) \
                if isinstance(x, torch.Tensor) else x

        return tuple(_tree_at(one, name, a) for name, a in
                     zip(ARG_NAMES[self.shape.kind], self.abstract_args))

    def blocks(self, args) -> dict:
        """Each DTensor argument's path -> [this rank's block shape, its
        sharding's spec] (a spec entry a name, a list of names or None)."""
        from torch.distributed.tensor import DTensor

        out = {}

        def one(path, x, sh):
            if isinstance(x, DTensor):
                out[path] = [list(x.to_local().shape),
                             [e if e is None or isinstance(e, str) else list(e)
                              for e in sh.spec]]

        for name, a, sh in zip(ARG_NAMES[self.shape.kind], args, self._arg_shardings()):
            _tree_at(one, name, a, sh)
        return out

    def _arg_shardings(self) -> tuple:
        """The shardings the arguments are cut by: ``in_shardings``, with
        the train state's as its DTensors hold it (on a folded mesh the
        ZeRO-1 moments over the folded axes, ``out_shardings``' state)."""
        if self.shape.kind == "train":
            return self.out_shardings[0], self.in_shardings[1]
        return tuple(self.in_shardings)

    def gather(self, out):
        """The whole value of every output on every rank (DTensor's
        ``full_tensor``; a world's groups stage its gathers where
        ``world.STAGED`` says)."""
        from torch.distributed.tensor import DTensor

        return _tree(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, out)

    def run(self, device="cuda", seed: int = 0, values=None) -> dict:
        """This rank's share of the step, once, on ``device``. Without
        ``values``, on seeded local blocks (weights N(0, 0.02), token ids
        below the vocabulary, optimizer moments and caches zero): the
        count phase's filler, whose values are those of no whole tensor
        (and, on a fake group, which moves no data, not even the
        collectives'). With ``values`` (a maker, see :meth:`place`), on
        this rank's blocks of them, and the record's ``"out"`` holds the
        outputs at ``out_shardings`` (:meth:`gather` makes them whole).
        Returns the seconds, the argument bytes, the devices the local
        blocks lie on and, on a card, the peak memory since the arguments
        were made."""
        from repro_torch.launch import flops

        dev = torch.device(device)
        mesh = dataclasses.replace(self.mesh, device=dev)
        if values is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            args = _seeded(self.abstract_args, gen, self.cfg.vocab_size, dev)
        else:
            args = self.place(values, dev)
        arg_bytes = flops.nbytes(args)
        local_devices = sorted({str(t.device) for t in _local_leaves(args)})
        cuda = dev.type == "cuda"
        if cuda:
            _backward_thread_replication(dev, True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        try:
            with self._settings(mesh):
                t0 = time.perf_counter()
                out = self._call(args)
                if cuda:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            if cuda:
                _backward_thread_replication(dev, False)
        record = {"step_s": seconds, "argument_bytes": arg_bytes,
                  "local_devices": local_devices,
                  "output_devices": sorted({str(t.device) for t in _local_leaves(out)}),
                  "peak_memory_bytes": None}
        if cuda:
            record["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        if values is not None:
            record.update(out=out, blocks=self.blocks(args))
        return record


def _backward_thread_replication(device, on: bool) -> None:
    """DTensor's implicit replication on (or off) in autograd's thread for
    ``device``. The flag is thread-local (torch 2.13's
    ``_set_dtensor_allow_implicit_replication``), and autograd runs a
    CUDA backward, remat recompute included, on a device thread of its
    own, where a plain tensor saved by the forward (a rotary table) meets
    the DTensor gradients. A one-node backward sets it there; where the
    flag is a plain attribute (older torch), it is global already."""
    setter = getattr(torch._C, "_set_dtensor_allow_implicit_replication", None)
    if setter is None:
        return

    class _Set(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            setter(on)
            return g

    _Set.apply(torch.zeros((), device=device, requires_grad=True)).backward()


def _tree(fn, *trees):
    """``fn`` over the leaves of matching nested dicts, lists, tuples and
    dataclasses (a None or non-tensor leaf is passed as it is)."""
    return _tree_at(lambda _, *xs: fn(*xs), "", *trees)


# The names of a cell's arguments by shape kind: the first key of a
# leaf's path in ``Cell.place``.
ARG_NAMES = {"train": ("state", "batch"), "prefill": ("params", "inputs"),
             "decode": ("params", "cache", "pos", "token")}


def _tree_at(fn, path: str, *trees):
    """``_tree`` whose ``fn`` also takes each leaf's path: ``path`` and the
    keys, fields or indices down to it, joined by '/'."""
    t = trees[0]
    if dataclasses.is_dataclass(t):
        return type(t)(*[_tree_at(fn, f"{path}/{f.name}", *[getattr(x, f.name) for x in trees])
                         for f in dataclasses.fields(t)])
    if isinstance(t, dict):
        return {k: _tree_at(fn, f"{path}/{k}", *[x[k] for x in trees]) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*[_tree_at(fn, f"{path}/{k}", *xs)
                         for k, *xs in zip(t._fields, *trees)])
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_at(fn, f"{path}/{i}", *xs) for i, xs in enumerate(zip(*trees)))
    return fn(path, *trees)


#: The optimizer state seeded values start from, as a run past warmup
#: holds it: the step at the end of warmup, so the rate is the peak's
#: (3e-4; at step 0 warmup's 3e-6 moves no parameter past the limits
#: that the cells are held to), and moments of scale
#: ``SEEDED_MOMENT`` (mu N(0, s), nu s^2 (0.5 + U[0, 1))). With zero
#: moments a leaf whose gradients are all below Adam's eps (a random
#: model's attention queries and keys) moves only by weight decay, 3e-5
#: of its largest entry; seeded moments move every parameter by some
#: lr, over 1e-3 of its leaf's largest, so a parameter that a step
#: failed to write fails the check, and they keep the update smooth
#: where a gradient crosses zero. Gradients above s still rule both
#: moments, and the moments' blocks carry values their placement must
#: keep.
SEEDED_STEP = opt_mod.AdamWConfig().warmup_steps
SEEDED_MOMENT = 1e-8


def seeded_values(seed: int, vocab: int, device="cuda"):
    """``Cell.place``'s maker of whole values from one seed, on ``device``:
    each floating leaf N(0, 0.02) (a decode cache N(0, 1)), the optimizer's
    step :data:`SEEDED_STEP` and moments of scale :data:`SEEDED_MOMENT`,
    token ids uniform below ``vocab``. Every leaf has its own generator, seeded by ``seed`` and its
    path, so a value does not depend on the order leaves are made in, nor
    on the mesh."""
    import zlib

    def make(path, like):
        if path == "pos":
            return like
        gen = torch.Generator(device=device).manual_seed(
            seed * 2 ** 32 + zlib.crc32(path.encode()))
        shape = tuple(like.shape)
        if path == "state/opt/step":
            return torch.full(shape, SEEDED_STEP, dtype=like.dtype, device=device)
        if path.startswith("state/opt/nu/"):
            return torch.rand(shape, generator=gen, device=device).add_(0.5).mul_(
                SEEDED_MOMENT ** 2).to(like.dtype)
        if not like.dtype.is_floating_point:
            return torch.randint(0, vocab, shape, generator=gen, device=device,
                                 dtype=like.dtype)
        scale = (1.0 if path.startswith("cache") else
                 SEEDED_MOMENT if path.startswith("state/opt/mu/") else 0.02)
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(scale).to(like.dtype)

    return make


def _spec_bytes(args, shardings) -> int:
    """This rank's bytes of ``args`` under ``shardings``, each leaf's block
    as its spec cuts it (on a folded mesh a ZeRO-1 moment's DTensor is cut
    over the folded axes, its spec over 'data' alone); the decode step's
    int position counts as the reference's int32 scalar, unless the step
    never reads it (its sharding None: jit drops an unused argument)."""
    total = []

    def one(x, sh):
        if isinstance(x, torch.Tensor):
            total.append(math.prod(sh.local_shape(x.shape)) * x.element_size())
        elif isinstance(x, int) and sh is not None:
            total.append(4)         # decode's position: the reference's int32 scalar

    _tree(one, args, shardings)
    return sum(total)


def _on_fold(sh, x):
    """A sharding of ``x`` as a mesh with folded axes can hold it: an entry
    that names part of the folded axes names them all, or none where
    they do not divide the dim. Only ZeRO-1's moments need it (their
    'data' on the multi mesh, replicated over 'pod')."""
    fold = sh.mesh.fold
    if not fold:
        return sh
    from repro_torch.launch.policy import NamedSharding

    size = math.prod(sh.mesh.axis_size(a) for a in fold)
    entries = []
    for d, e in enumerate(sh.spec):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        if set(names) & set(fold):
            e = fold if x.shape[d] % size == 0 else None
        entries.append(e)
    return NamedSharding(sh.mesh, spmd_P(*entries))


def _local_leaves(tree) -> list:
    out = []
    _tree(lambda x: out.append(getattr(x, "_local_tensor", x))
          if isinstance(x, torch.Tensor) else None, tree)
    return out


def _place(out, shardings):
    """``out``'s DTensors redistributed to ``shardings`` (a matching tree
    of ``NamedSharding``)."""
    def one(x, sh):
        if sh is None or not hasattr(x, "placements"):
            return x
        want = sh.placements(x.ndim)
        return x if tuple(x.placements) == tuple(want) else x.redistribute(
            sh.mesh.dist, want)

    return _tree(one, out, shardings)


# XLA's output_size_in_bytes counts a tuple output's index table: one
# 8-byte pointer a leaf (smollm-135m's train step: 37 leaves, 296 bytes).
TUPLE_POINTER_BYTES = 8


def _output_bytes(out, args) -> tuple[float, float]:
    """This rank's output bytes as XLA's memory analysis counts them (the
    leaves, and a tuple's pointer table when there are several), and
    those of outputs that are an argument updated in place (the
    reference's donated, aliased outputs)."""
    ins = {id(t) for t in _local_leaves(args)}
    leaves = _local_leaves(out)
    total = alias = 0
    for t in leaves:
        b = t.numel() * t.element_size()
        total += b
        alias += b if id(t) in ins else 0
    if len(leaves) > 1:
        total += TUPLE_POINTER_BYTES * len(leaves)
    return float(total), float(alias)


def _seeded(abstract, gen: torch.Generator, vocab: int, device):
    """Local blocks on ``device`` for a cell's meta DTensor arguments, each
    wrapped back with its placements and global shape."""
    from torch.distributed.tensor import DTensor

    def fill(zero):
        def one(x):
            if not isinstance(x, DTensor):
                return x
            loc = x._local_tensor
            if not loc.dtype.is_floating_point:
                t = torch.randint(0, vocab, loc.shape, generator=gen, device=device,
                                  dtype=loc.dtype)
            elif zero:
                t = torch.zeros(loc.shape, dtype=loc.dtype, device=device)
            else:
                t = torch.randn(loc.shape, generator=gen, device=device,
                                dtype=torch.float32).mul_(0.02).to(loc.dtype)
            return DTensor.from_local(t, x.device_mesh, x.placements, run_check=False,
                                      shape=x.shape, stride=x.stride())
        return one

    if isinstance(abstract[0], TrainState):
        state, batch = abstract
        return (TrainState(_tree(fill(False), state.params),
                           _tree(fill(True), state.opt), None),
                _tree(fill(False), batch))
    if len(abstract) == 2:                          # prefill: params, inputs
        return tuple(_tree(fill(False), a) for a in abstract)
    params, cache, pos, token = abstract            # decode
    return (_tree(fill(False), params), _tree(fill(True), cache), pos,
            _tree(fill(False), token))


def make_cell(arch: str, cfg: ModelConfig, shape: ShapeConfig, mesh, *,
              mode: str | None = None, seq_shard: bool = True) -> Cell:
    """The cell of one (arch x shape) on ``mesh``, a ``spmd.Mesh`` on a
    process group (``core/world.py::on_world``): the train step (with
    ``choose_microbatches`` from the mesh's data and model sizes), the
    plain prefill or one decode step, on meta DTensors placed by the
    plan: the train state with ``opt_moments``, the batch with
    ``batch_like``, the cache with ``plan.cache``. The plain route, as the
    reference's cells (``use_pallas=False``): no kernel launches."""
    from repro_torch.launch import policy as policy_mod
    from repro_torch.launch import specs
    from repro_torch.models.params import abstract_params
    from repro_torch.models.registry import build

    if mesh.dist is None:
        raise ValueError("make_cell needs a mesh on a process group "
                         "(core/world.py::on_world)")
    model = build(cfg)
    plan = policy_mod.make_plan(cfg, mesh, mode)

    def place(tree, shardings):
        return _tree(lambda x, sh: sh.distribute(x), tree, shardings)

    p_sh = plan.params(model.schema)
    params = place(abstract_params(model.schema), p_sh)
    if shape.kind == "train":
        m_sh = plan.opt_moments(model.schema)
        m_dt = tree_map(_on_fold, m_sh, abstract_params(model.schema, torch.float32))
        moments = lambda: place(abstract_params(model.schema, torch.float32), m_dt)  # noqa: E731
        state_sh = TrainState(p_sh, opt_mod.AdamWState(plan.replicated(), m_sh, m_sh), None)
        state_out = TrainState(p_sh, opt_mod.AdamWState(plan.replicated(), m_dt, m_dt), None)
        state = TrainState(params, opt_mod.AdamWState(
            plan.replicated().distribute(torch.empty((), dtype=torch.int32, device="meta")),
            moments(), moments()), None)
        batch = specs.batch_specs(cfg, shape)
        batch_sh = plan.batch_like(batch)
        n_micro = choose_microbatches(cfg, shape, *mesh_dims(mesh))
        metrics_sh = {"loss": plan.replicated(), "grad_norm": plan.replicated(),
                      "lr": plan.replicated()}
        return Cell(arch, cfg, shape, make_train_step(model, shape, n_micro=n_micro),
                    (state, place(batch, batch_sh)), (state_sh, batch_sh),
                    (state_out, metrics_sh), plan, mesh, seq_shard, n_micro)
    if shape.kind == "prefill":
        inputs = specs.prefill_specs(cfg, shape)["inputs"]
        in_sh = plan.batch_like({"inputs": inputs})["inputs"]
        return Cell(arch, cfg, shape, make_prefill_step(model, use_kernel=False),
                    (params, in_sh.distribute(inputs)), (p_sh, in_sh),
                    plan.replicated(), plan, mesh, seq_shard)
    d = specs.decode_specs(cfg, shape)
    cache_sh = plan.cache(d["cache"])
    tok_sh = plan.batch_like({"t": d["token"]})["t"]
    logits_sh = plan.batch_like({"l": ((shape.global_batch, 1), torch.float32)})["l"]
    return Cell(arch, cfg, shape, make_serve_step(model),
                (params, place(d["cache"], cache_sh), shape.seq_len - 1,
                 tok_sh.distribute(d["token"])),
                (p_sh, cache_sh,
                 plan.replicated() if getattr(model, "decode_reads_pos", True) else None,
                 tok_sh), (logits_sh, cache_sh),
                plan, mesh, seq_shard)
