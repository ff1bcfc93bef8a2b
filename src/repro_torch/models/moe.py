"""Mixture-of-Experts FFN: top-k routing and capacity dispatch.

The port of ``repro.models.moe`` on one card. Sort-free capacity-based
dispatch (GShard/Switch style): tokens are scattered into a
(groups, experts, capacity, d_model) buffer through flat indices, so
routing metadata is O(N*K) and expert activations O(E*C*D), never a
(tokens, experts, capacity) one-hot. Expert counts that do not divide the
reference's 16-way model axis (qwen2-moe: 60) are padded with dummy
experts that the router masks and never picks.

``moe_apply`` picks the reference's path: with a mesh in scope, sequence
sharding on and the shapes dividing, the expert-parallel
``_moe_shard_map`` (explicit all-to-alls over the model axis, on the
virtual ranks of ``core/spmd.py``), else ``_moe_dense``. Both route
through ``route`` and ``dispatch_slots``, the ranks being the groups of
the expert-parallel path. The expert products are plain batched matmuls,
as the reference's einsums are: no Pallas kernel serves the MoE FFN.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import spmd
from repro_torch.models import layers
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, normal_init

CAPACITY_FACTOR = 1.25

# Below this per-group token count the dispatch uses full capacity
# (C = Ng): routing is then exact (no overflow dropping), at the cost of a
# (G, E, Ng, D) buffer. Above it the fixed capacity applies, so outputs
# can differ across this boundary by design (dropped overflow tokens).
EXACT_DISPATCH_MAX_TOKENS = 512

# Router logit of a padded dummy expert: its softmax probability is 0.
PAD_LOGIT = -1e30


def moe_schema(cfg: ModelConfig) -> dict:
    e = cfg.padded_experts
    d, f = cfg.d_model, cfg.moe_d_ff
    schema = {
        "router": ParamDef((d, e), ("embed", "experts"), normal_init(0.02)),
        "w_gate": ParamDef((e, d, f), ("experts", "embed", "ffn")),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "ffn")),
        "w_down": ParamDef((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.n_shared_experts:
        shared_ff = cfg.shared_d_ff or cfg.moe_d_ff * cfg.n_shared_experts
        schema["shared"] = layers.swiglu_schema(d, shared_ff)
    return schema


def capacity(n_tokens: int, n_experts: int, topk: int) -> int:
    c = int(n_tokens * topk * CAPACITY_FACTOR / n_experts)
    return max(4, (c + 3) // 4 * 4)


def dispatch_capacity(n_group_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a group of ``n_group_tokens``: all of them up
    to ``EXACT_DISPATCH_MAX_TOKENS`` (exact routing), else ``capacity``."""
    if n_group_tokens <= EXACT_DISPATCH_MAX_TOKENS:
        return n_group_tokens
    return capacity(n_group_tokens, cfg.n_experts, cfg.topk)


def route(params, xg: torch.Tensor, cfg: ModelConfig):
    """The fp32 router over grouped tokens xg (G, Ng, D): logits and
    softmax probabilities (G, Ng, E), with padded experts masked, and the
    top-k gates, renormalised, and expert ids (G, Ng, K)."""
    logits = xg.to(torch.float32) @ params["router"].to(torch.float32)
    E = cfg.padded_experts
    if E != cfg.n_experts:
        pad = torch.arange(E, device=xg.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, PAD_LOGIT)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.topk, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate_vals, expert_idx


def dispatch_slots(expert_idx: torch.Tensor, n_experts: int, C: int):
    """Each (token, choice)'s rank in its expert's queue, tokens in order
    within a group (a stable argsort, ``searchsorted`` for each expert's
    first entry, ranks scattered back), and whether it fits the first C
    slots. expert_idx (G, Ng, K) -> pos_in_e, keep (G, Ng*K)."""
    G = expert_idx.shape[0]
    e_flat = expert_idx.reshape(G, -1)
    NgK = e_flat.shape[1]
    order = torch.argsort(e_flat, dim=1, stable=True)
    sorted_e = torch.gather(e_flat, 1, order)
    experts = torch.arange(n_experts, device=e_flat.device).expand(G, n_experts)
    starts = torch.searchsorted(sorted_e, experts.contiguous(), side="left")
    rank_sorted = (torch.arange(NgK, device=e_flat.device)[None]
                   - torch.gather(starts, 1, sorted_e))
    pos_in_e = torch.zeros_like(e_flat).scatter_(1, order, rank_sorted)
    return pos_in_e, pos_in_e < C


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (out, aux_loss). Dispatches to the explicit
    shard_map EP path (train/prefill under a mesh with sequence sharding)
    or the dense path (no mesh / decode)."""
    mesh = shd._current_mesh()
    if mesh is not None and shd.MODEL_AXIS in mesh.axis_names:
        batch_axes, dp, ep = layers._mesh_dims(mesh)
        B, S, _ = x.shape
        if (
            shd.seq_axis() == shd.MODEL_AXIS
            and cfg.padded_experts % ep == 0
            and B % dp == 0
            and S % ep == 0
        ):
            return _moe_shard_map(params, x, cfg, mesh, batch_axes, ep, dp)
    return _moe_dense(params, x, cfg)


def _moe_shard_map(params, x, cfg: ModelConfig, mesh, batch_axes, ep, dp):
    """Expert parallelism with explicit all_to_all collectives (the
    DeepSpeed/GShard schedule): each rank routes its own (batch x seq)
    token shard into per-expert send buckets with a local capacity
    (``capacity(Nl, ...)``, not the dense path's ``dispatch_capacity``:
    the two drop differently, and agree when neither drops),
    all_to_all's the buckets to the expert owners along the model axis,
    runs its local experts, and reverses the exchange.

    On virtual ranks the body sees every rank's block at once: ranks are
    the groups of ``route`` and ``dispatch_slots``, and each expert
    product folds the batch-axis ranks into its token dim, so the
    model-sharded weights are read as they are, not copied for each
    replica. On a process group it sees its own block (one group, its
    own (E_l, D, F) experts); ``spmd.lead_dims()`` tells the two apart."""
    spmd.count("moe_shard_map")
    E = cfg.padded_experts
    K = cfg.topk
    E_l = E // ep
    nd = mesh.ndim
    a = mesh.axis(shd.MODEL_AXIS)
    others = [d for d in range(nd) if d != a]
    all_axes = tuple(batch_axes) + (shd.MODEL_AXIS,)
    n_dev = dp * ep
    # rank -> its model-axis block: index 0 along every other mesh dim
    own = tuple(slice(None) if d == a else 0 for d in range(nd))

    def body(x_l, router, wg, wu, wd):
        L = spmd.lead_dims()
        lead = tuple(x_l.shape[:L])
        *_, Bl, Sl, D = x_l.shape
        Nl = Bl * Sl
        R = math.prod(lead)
        dt = x_l.dtype
        dev = x_l.device
        stacked = lambda t: t.reshape(lead + tuple(t.shape[1:]))  # noqa: E731
        xg = x_l.reshape(R, Nl, D)                     # ranks as groups
        logits, probs, gate_vals, expert_idx = route(
            {"router": router[(0,) * L]}, xg, cfg)
        # ---- aux loss from psum-averaged stats (the z-loss stays local)
        me = spmd.psum(stacked(probs.mean(dim=1)), all_axes) / n_dev
        flat = expert_idx.reshape(R, Nl * K)
        counts = torch.zeros((R, E), dtype=torch.float32, device=dev).scatter_add_(
            1, flat, torch.ones(flat.shape, dtype=torch.float32, device=dev))
        ce = spmd.psum(stacked(counts), all_axes) / (Nl * K * n_dev)
        aux = cfg.n_experts * torch.sum(me * ce, dim=-1)
        aux = aux + stacked(torch.mean(torch.logsumexp(logits, dim=-1) ** 2, dim=-1)) * 1e-4

        # ---- local dispatch into per-expert send buckets
        C = capacity(Nl, cfg.n_experts, K)
        pos_in_e, keep = dispatch_slots(expert_idx, E, C)
        tok_flat = (torch.arange(Nl * K, device=dev) // K).expand(R, Nl * K)
        r_idx = torch.arange(R, device=dev)[:, None].expand(R, Nl * K)
        w = (gate_vals.reshape(R, Nl * K) * keep).to(dt)
        safe_pos = torch.where(keep, pos_in_e, C - 1)
        contrib = torch.where(keep[..., None], xg[r_idx, tok_flat],
                              torch.zeros((), dtype=dt, device=dev))
        send = torch.zeros((R, E, C, D), dtype=dt, device=dev)
        send.index_put_((r_idx, flat, safe_pos), contrib, accumulate=True)

        # ---- EP all_to_all: (ep, E_l, C, D) -> (ep senders, E_l, C, D)
        recv = spmd.all_to_all(send.reshape(*lead, ep, E_l, C, D),
                               shd.MODEL_AXIS, split_axis=0, concat_axis=0)
        if L:
            # Each expert owner's tokens, the other ranks' folded in:
            # (*mesh, ep_s, E_l, C, D) -> (ep, E_l, others * ep_s * C, D)
            h = recv.permute(a, nd + 1, *others, nd, nd + 2, nd + 3).reshape(ep, E_l, -1, D)
            wg, wu, wd = wg[own], wu[own], wd[own]
        else:
            h = recv.transpose(0, 1).reshape(E_l, ep * C, D)
        del send, recv

        # ---- local expert FFN, on each owner's (E_l, D, F) weights
        g = torch.matmul(h, wg.to(dt))
        u = torch.matmul(h, wu.to(dt))
        y = torch.matmul(F.silu(g) * u, wd.to(dt))
        del h, g, u

        # ---- reverse exchange: back to (*lead, ep_s, E_l, C, D)
        if L:
            y = y.reshape(ep, E_l, *[mesh.shape[d] for d in others], ep, C, D)
            back = [0 if d == a else 2 + others.index(d) for d in range(nd)]
            y = y.permute(*back, nd + 1, 1, nd + 2, nd + 3)
        else:
            y = y.reshape(E_l, ep, C, D).transpose(0, 1)
        y_back = spmd.all_to_all(y, shd.MODEL_AXIS, split_axis=0, concat_axis=0)
        y_back = y_back.reshape(R, E, C, D)

        # ---- combine
        gathered = y_back[r_idx, flat, safe_pos] * w[..., None]
        out = torch.zeros((R, Nl, D), dtype=dt, device=dev)
        out.index_put_((r_idx, tok_flat), gathered, accumulate=True)
        return out.reshape(*lead, Bl, Sl, D), aux

    x_spec = spmd.P(batch_axes if batch_axes else None, shd.MODEL_AXIS, None)
    w_spec = spmd.P(shd.MODEL_AXIS, None, None)
    out, aux = spmd.shard_map(
        body, mesh, (x_spec, spmd.P(None, None), w_spec, w_spec, w_spec),
        (x_spec, spmd.P()),
    )(x, params["router"], params["w_gate"], params["w_up"], params["w_down"])
    if cfg.n_shared_experts:
        out = out + layers.swiglu(params["shared"], x)
    return out, aux


def _moe_dense(params, x: torch.Tensor, cfg: ModelConfig):
    """The dense path (no mesh, or decode steps with few tokens).

    Group-local dispatch: tokens are routed within G = ``moe_groups()``
    groups (1 unless set; 1 when G does not divide the tokens). Every
    shape comes from x's, so no step waits for the card (``bincount`` or
    a tensor ``repeat_interleave`` would). A DTensor on a mesh on a
    process group takes ``_moe_dense_pg``."""
    mesh = shd._current_mesh()
    if mesh is not None and mesh.dist is not None and shd._is_dtensor(x):
        return _moe_dense_pg(params, x, cfg, mesh)
    B, S, D = x.shape
    N = B * S
    G = shd.moe_groups()
    if N % G != 0:
        G = 1
    xg = shd.constrain(x.reshape(G, N // G, D), shd.BATCH_AXES)
    dt = x.dtype

    def experts(buf):
        buf = shd.constrain(buf, shd.BATCH_AXES, shd.MODEL_AXIS)   # EP all-to-all boundary
        gh = torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(dt))
        uh = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(dt))
        y = torch.einsum("gecf,efd->gecd", F.silu(gh) * uh, params["w_down"].to(dt))
        return shd.constrain(y, shd.BATCH_AXES, shd.MODEL_AXIS)

    out, (me, ce, z) = _dispatch_combine(params["router"], xg, cfg, experts)
    aux = cfg.n_experts * torch.sum(me * ce) + z * 1e-4
    out = shd.constrain(out, shd.BATCH_AXES).reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + layers.swiglu(params["shared"], x)
    return out, aux


def _dispatch_combine(router, xg, cfg: ModelConfig, experts):
    """Route grouped tokens xg (G, Ng, D), dispatch them into a
    (G, E, C, D) buffer, run ``experts(buf)`` -> y of the buffer's shape,
    and combine y back to tokens (G, Ng, D). Also returns the aux loss's
    statistics: the mean router probabilities and the share of choices
    per expert (E,), and the mean squared router log-sum-exp."""
    G, Ng, D = xg.shape
    E = cfg.padded_experts
    K = cfg.topk
    dev = xg.device
    logits, probs, gate_vals, expert_idx = route({"router": router}, xg, cfg)
    me = probs.reshape(G * Ng, E).mean(dim=0)
    flat_idx = expert_idx.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, flat_idx, torch.ones(flat_idx.shape, dtype=torch.float32, device=dev)
    ) / (G * Ng * K)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # ---- capacity-based dispatch
    C = dispatch_capacity(Ng, cfg)
    NgK = Ng * K
    e_flat = expert_idx.reshape(G, NgK)
    pos_in_e, keep = dispatch_slots(expert_idx, E, C)
    tok_flat = (torch.arange(NgK, device=dev) // K).expand(G, NgK)
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, NgK)
    w = (gate_vals.reshape(G, NgK) * keep).to(xg.dtype)
    safe_pos = torch.where(keep, pos_in_e, C - 1)
    contrib = torch.where(keep[..., None], xg[g_idx, tok_flat],
                          torch.zeros((), dtype=xg.dtype, device=dev))
    contrib = shd.constrain(contrib, shd.BATCH_AXES)
    buf = torch.zeros((G, E, C, D), dtype=xg.dtype, device=dev)
    buf.index_put_((g_idx, e_flat, safe_pos), contrib, accumulate=True)
    y = experts(buf)

    # ---- combine back to tokens
    gathered = shd.constrain(y[g_idx, e_flat, safe_pos] * w[..., None], shd.BATCH_AXES)
    out = torch.zeros((G, Ng, D), dtype=xg.dtype, device=dev)
    out.index_put_((g_idx, tok_flat), gathered, accumulate=True)
    return out, (me, ce, z)


def _moe_dense_pg(params, x, cfg: ModelConfig, mesh):
    """The dense path on a mesh on a process group: what the reference's
    constraints make XLA do with it (token groups over the data shards,
    the buffer's experts over 'model'), written out as a shard_map, since
    DTensor has no rule for routing's sorts and scatters. Each rank routes
    its data shard's tokens into its groups' buffer, runs its E/ep
    experts on its slice of the buffer, and the model axis all-gathers
    the experts' outputs for the combine; the aux statistics are
    ``psum``-averaged over the data shards."""
    batch_axes, dp, ep = layers._mesh_dims(mesh)
    E = cfg.padded_experts
    E_l = E // ep
    B, S, D = x.shape
    sharded = bool(batch_axes) and B % dp == 0
    n = dp if sharded else 1
    G = shd.moe_groups()
    G_l = G // n if G % n == 0 and (B * S // n) % max(G // n, 1) == 0 else 1
    G_l = max(G_l, 1)
    dt = x.dtype

    def body(x_l, router, wg, wu, wd):
        Bl = x_l.shape[0]
        xg = x_l.reshape(G_l, Bl * S // G_l, D)
        own = spmd.axis_index(shd.MODEL_AXIS) * E_l + torch.arange(E_l, device=x_l.device)

        def experts(buf):
            b = buf.index_select(1, own)
            gh = torch.einsum("gecd,edf->gecf", b, wg.to(dt))
            uh = torch.einsum("gecd,edf->gecf", b, wu.to(dt))
            y = torch.einsum("gecf,efd->gecd", F.silu(gh) * uh, wd.to(dt))
            return spmd.all_gather(y, shd.MODEL_AXIS, dim=1, tiled=True)

        out, (me, ce, z) = _dispatch_combine(router, xg, cfg, experts)
        if sharded:
            me = spmd.psum(me, batch_axes) / n
            ce = spmd.psum(ce, batch_axes) / n
        aux = cfg.n_experts * torch.sum(me * ce) + z * 1e-4
        return out.reshape(Bl, S, D), aux

    x_spec = spmd.P(batch_axes if sharded else None, None, None)
    w_spec = spmd.P(shd.MODEL_AXIS, None, None)
    out, aux = spmd.shard_map(
        body, mesh, (x_spec, spmd.P(None, None), w_spec, w_spec, w_spec),
        (x_spec, spmd.P()),
    )(x, params["router"], params["w_gate"], params["w_up"], params["w_down"])
    if cfg.n_shared_experts:
        out = out + layers.swiglu(params["shared"], x)
    return out, aux
