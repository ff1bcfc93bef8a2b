"""Training loop: the train step, bounded async dispatch, checkpoint cadence.

The port of ``repro.training.loop``. The step runs eagerly: autograd
through ``model.loss`` on the plain path (no kernel has a backward, and
the reference trains with ``use_pallas=False`` too), then the optional
gradient compression, then the in-place AdamW update.

The dispatch bound is the paper's ``Backpressure`` directive put to work:
at most ``backpressure`` steps are in flight before the loop blocks on
the oldest result. The step's metrics stay tensors on the card, read
(``float``) only when a step leaves the in-flight queue, so the card runs
that many steps behind the host, as XLA's asynchronous dispatch lets the
reference's.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.models.params import tree_leaves
from repro_torch.runtime import compression
from repro_torch.training import optimizer as opt_mod


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: opt_mod.AdamWState
    error: Any = None               # compression error feedback (optional)

    def as_tree(self) -> dict:
        tree = {"params": self.params, "opt_mu": self.opt.mu,
                "opt_nu": self.opt.nu, "opt_step": self.opt.step}
        if self.error is not None:
            tree["error"] = self.error
        return tree

    @classmethod
    def from_tree(cls, tree: dict) -> "TrainState":
        return cls(
            params=tree["params"],
            opt=opt_mod.AdamWState(
                step=torch.as_tensor(tree["opt_step"]),
                mu=tree["opt_mu"], nu=tree["opt_nu"],
            ),
            error=tree.get("error"),
        )


def value_and_grad(loss_fn: Callable, params) -> tuple[torch.Tensor, Any]:
    """``loss_fn(params)`` and its gradient, a tree shaped as ``params``
    (the counterpart of ``jax.value_and_grad``): every leaf is marked to
    require grad, and a leaf the loss does not reach gets zeros."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params)
    grads = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        return next(grads)

    return loss.detach(), rebuild(params)


def make_train_step(model, opt_cfg: opt_mod.AdamWConfig, *,
                    use_kernel: bool = False, remat: bool = True,
                    compress_grads: bool = False) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); the state's
    tensors are updated in place and returned."""

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = value_and_grad(
            lambda p: model.loss(p, batch, use_kernel=use_kernel, remat=remat),
            state.params)
        error = state.error
        if compress_grads and error is not None:
            grads, error = compression.compress_tree(grads, error)
        params, opt_state, metrics = opt_mod.update(
            opt_cfg, grads, state.opt, state.params)
        return TrainState(params, opt_state, error), {"loss": loss, **metrics}

    return train_step


def init_state(model, generator: torch.Generator, opt_cfg: opt_mod.AdamWConfig,
               *, device="cuda", compress_grads: bool = False) -> TrainState:
    """Parameters drawn from ``generator`` (on ``device``'s type), zero
    moments, and the error buffer when ``compress_grads``."""
    params = model.init(generator, device=device)
    opt_state = opt_mod.init(params)
    error = compression.init_error(params) if compress_grads else None
    return TrainState(params, opt_state, error)


@dataclasses.dataclass
class TrainLoop:
    step_fn: Callable                     # (state, batch) -> (state, metrics)
    pipeline: Any                         # repro_torch.data pipeline
    backpressure: int = 2
    checkpoint_manager: Any = None
    save_every: int = 0

    def run(self, state: TrainState, start_step: int, n_steps: int,
            *, log_every: int = 10,
            on_step: Callable | None = None) -> tuple[TrainState, list[dict]]:
        in_flight: collections.deque = collections.deque()
        history: list[dict] = []
        t0 = time.perf_counter()

        def retire():
            s, m = in_flight.popleft()
            m = {k: float(v) for k, v in m.items()}
            m["step"] = s
            history.append(m)
            if on_step is not None:
                on_step(s, m)
            return s, m

        for step in range(start_step, n_steps):
            batch = self.pipeline.batch(step)
            state, metrics = self.step_fn(state, batch)
            in_flight.append((step, metrics))
            # Backpressure: bound async dispatch depth.
            while len(in_flight) > self.backpressure:
                s, m = retire()
                if log_every and s % log_every == 0:
                    dt = time.perf_counter() - t0
                    print(f"step {s:5d} loss {m['loss']:.4f} "
                          f"gnorm {m['grad_norm']:.3f} ({dt:.1f}s)")
            if (
                self.checkpoint_manager is not None
                and self.save_every
                and (step + 1) % self.save_every == 0
            ):
                self.checkpoint_manager.save(
                    step + 1, state.as_tree(), {"cursor": step + 1}
                )
        while in_flight:
            retire()
        return state, history
