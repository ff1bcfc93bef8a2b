"""Pipeline parallelism across pods (GPipe-style, shard_map + ppermute).

The port of ``repro.training.pipeline`` on the single-process substrate
(``core/spmd.py``). Multi-pod meshes pay DCI prices for cross-pod
collectives; pipelining sends only ACTIVATIONS across the pod boundary
instead of gradient all-reduces. The layer stack is split into one
contiguous stage per pod; microbatches stream through the classic skewed
schedule:

    t:        0    1    2    3   ...
    stage 0:  m0   m1   m2   m3
    stage 1:       m0   m1   m2

A shard_map over the 'pod' axis whose body runs the local stage and
ppermutes activations to the next stage. Every tick runs every stage,
the bubble's ticks included: T = M + S - 1 ticks. Bubble fraction =
(S-1)/(M+S-1). Autograd differentiates straight through (the backward of
ppermute's indexing is the reverse permute), giving a correct (GPipe,
all-microbatch-stash) backward.

On virtual ranks the body sees every rank's block at once (the mesh
dims lead), so ``layer_fn`` — which applies ONE layer to one rank's
block, as in the reference — runs under ``torch.func.vmap`` over the
mesh dims: each stage applies its own layer to its own activation, all
stages in one call. On a process group (``core/world.py``) the body sees
its own block and calls ``layer_fn`` as it is (``spmd.lead_dims()`` is
0). The tick loop's indices are Python ints; only "which stage am I"
is a per-rank tensor (``spmd.axis_index``), applied through
``spmd.where``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import spmd
from repro_torch.core.spmd import P
from repro_torch.models.params import tree_leaves, tree_map


def split_stages(stacked_params: Any, n_stages: int) -> Any:
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-major."""

    def reshape(p):
        L = p.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return p.reshape((n_stages, L // n_stages) + tuple(p.shape[1:]))

    return tree_map(reshape, stacked_params)


def _unflatten(like, leaves: list):
    """A tree of ``like``'s structure (keys sorted, as ``tree_leaves``)
    from its leaves in order."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        return next(it)

    return rec(like)


def pipelined_apply(
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh: spmd.Mesh,
    *,
    pod_axis: str = "pod",
    n_microbatches: int,
):
    """Build fn(stage_params, x) -> y running the layer stack pipelined.

    ``layer_fn(layer_params, x) -> x`` applies ONE layer. ``stage_params``
    is the (S, L/S, ...) tree from split_stages, sharded over the pod axis
    on dim 0; ``x`` is (M, Bm, ...) microbatch-major, replicated across the
    pod axis (each stage uses only its schedule slice).
    """
    n_stages = mesh.axis_size(pod_axis)

    def stage_apply(rank_fn, L, local, x):
        # local: (*lead, L/S, ...) leaves; x: (*lead, Bm, ...)
        n_layers = tree_leaves(local)[0].shape[L]
        for i in range(n_layers):
            x = rank_fn(tree_map(lambda p: p.select(L, i), local), x)
        return x

    def run(like):
        def body(*args):
            *leaves, x_all = args
            L = spmd.lead_dims()               # leading mesh dims of a block
            rank_fn = layer_fn
            for _ in range(L):                 # one vmap a mesh dim
                rank_fn = torch.func.vmap(rank_fn)
            # leaves: (*lead, 1, L/S, ...) local slices; x_all: (*lead, M, Bm, ...)
            local = _unflatten(like, [p.select(L, 0) for p in leaves])
            stage = spmd.axis_index(pod_axis)
            M = x_all.shape[L]
            first, last = stage == 0, stage == n_stages - 1
            carry = torch.zeros_like(x_all.select(L, 0))
            outputs = [None] * M
            for t in range(M + n_stages - 1):
                # stage 0 ingests microbatch t (when valid); the others take
                # the activation handed over at the previous tick.
                feed = spmd.where(first, x_all.select(L, min(t, M - 1)), carry)
                out = stage_apply(rank_fn, L, local, feed)
                # hand to the next stage (ring; the wraparound is never read)
                carry = spmd.ppermute(
                    out, pod_axis, [(i, (i + 1) % n_stages) for i in range(n_stages)])
                # the last stage emits microbatch t - (S-1) at tick t
                if t >= n_stages - 1:
                    outputs[t - (n_stages - 1)] = out
            y = torch.stack(outputs, L)
            # Make the result identical on every pod (the last stage owns it).
            return spmd.psum(spmd.where(last, y, torch.zeros_like(y)), pod_axis)

        return body

    def apply(stage_params, x_microbatched):
        leaves = tree_leaves(stage_params)
        fn = spmd.shard_map(run(stage_params), mesh,
                            in_specs=(P(pod_axis),) * len(leaves) + (P(),),
                            out_specs=P())
        return fn(*leaves, x_microbatched)

    return apply


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
