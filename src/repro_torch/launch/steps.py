"""Step functions of the launchers (``repro.launch.steps.make_cell``'s train,
prefill and decode branches).

The reference builds a lowering cell per (arch x shape): a step callable
plus abstract arguments and shardings for XLA. Here the step callables
are what is left: the abstract arguments are ``launch/specs.py``'s meta
tensors, and the dry run (``launch/dryrun.py``) counts a step on them in
place of lowering it. ``mesh_settings`` is ``make_cell``'s setting of the
model's mesh switches (sequence sharding, the layer barrier, the MoE
groups) for one cell; the shardings themselves are ``launch/policy.py``'s
plan. The train step keeps the
reference's gradient accumulation, with the accumulation factor from
``choose_microbatches``; its loop over microbatches goes through
``models/loops.py``, so the count takes one microbatch for all.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

from repro_torch.models import loops
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.loop import TrainState, value_and_grad


@contextlib.contextmanager
def mesh_settings(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """The mesh settings of the reference's ``make_cell`` for one cell,
    restored on exit: sequence sharding over 'model' for train and prefill
    shapes whose length divides by 16, the layer barrier under FSDP, and
    MoE dispatch groups = gcd(data shards, tokens per step). ``mesh`` is a
    ``spmd.Mesh`` (None: one card, one data shard); it is put in scope
    for the block. Yields the sharding mode, ``policy.choose_mode(cfg)``."""
    from repro_torch.core import spmd
    from repro_torch.launch.policy import choose_mode
    from repro_torch.models import sharding as shd

    saved = (shd.seq_axis(), shd._LAYER_BARRIER, shd.moe_groups())
    mode = choose_mode(cfg)
    shd.set_sequence_sharding(
        "model" if (shape.kind in ("train", "prefill")
                    and shape.seq_len % 16 == 0) else None)
    shd.set_layer_barrier(mode == "fsdp")
    dp_total = 1
    for ax in ("pod", "data"):
        if mesh is not None and ax in mesh.axis_names:
            dp_total *= mesh.axis_size(ax)
    tokens_per_step = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    shd.set_moe_groups(math.gcd(dp_total, tokens_per_step))
    try:
        with spmd.use_mesh(mesh):
            yield mode
    finally:
        shd.set_sequence_sharding(saved[0])
        shd.set_layer_barrier(saved[1])
        shd.set_moe_groups(saved[2])


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
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
                     for k, v in batch.items()}
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
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
        return model.last_logits(params, inputs, use_kernel=use_kernel)

    return prefill_step


def make_serve_step(model) -> Callable:
    """``serve_step(params, cache, pos, token)`` -> (logits, cache): one
    decode step; the cache is updated in place."""

    @torch.no_grad()
    def serve_step(params, cache, pos, token):
        return model.decode_step(params, cache, pos, token)

    return serve_step
