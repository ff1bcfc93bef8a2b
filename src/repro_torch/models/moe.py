"""Mixture-of-Experts FFN: top-k routing and capacity dispatch.

The port of ``repro.models.moe`` on one card. Sort-free capacity-based
dispatch (GShard/Switch style): tokens are scattered into a
(groups, experts, capacity, d_model) buffer through flat indices, so
routing metadata is O(N*K) and expert activations O(E*C*D), never a
(tokens, experts, capacity) one-hot. Expert counts that do not divide the
reference's 16-way model axis (qwen2-moe: 60) are padded with dummy
experts that the router masks and never picks.

With no mesh the reference always takes its dense path, and so does the
port: ``moe_apply`` is the reference's ``_moe_dense``. The expert-parallel
``_moe_shard_map`` (explicit all-to-alls) comes with the multi-card
substrate. The expert products are plain batched matmuls, as the
reference's einsums are: no Pallas kernel serves the MoE FFN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, normal_init
from repro_torch.models.sharding import moe_groups

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
    """x: (B, S, D) -> (out, aux_loss), through the reference's dense path
    (``_moe_dense``, which it takes with no mesh, as on one card).

    Group-local dispatch: tokens are routed within G = ``moe_groups()``
    groups (1 unless set; 1 when G does not divide the tokens). Every
    shape comes from x's, so no step waits for the card (``bincount`` or
    a tensor ``repeat_interleave`` would)."""
    B, S, D = x.shape
    E = cfg.padded_experts
    K = cfg.topk
    N = B * S
    G = moe_groups()
    if N % G != 0:
        G = 1
    Ng = N // G
    xg = x.reshape(G, Ng, D)

    logits, probs, gate_vals, expert_idx = route(params, xg, cfg)

    # ---- aux losses (load balance + router z-loss), global
    me = probs.reshape(N, E).mean(dim=0)
    flat_idx = expert_idx.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, flat_idx, torch.ones(flat_idx.shape, dtype=torch.float32, device=x.device)
    ) / (N * K)
    aux = cfg.n_experts * torch.sum(me * ce)
    aux = aux + torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * 1e-4

    # ---- capacity-based dispatch
    C = dispatch_capacity(Ng, cfg)
    NgK = Ng * K
    e_flat = expert_idx.reshape(G, NgK)
    pos_in_e, keep = dispatch_slots(expert_idx, E, C)
    tok_flat = (torch.arange(NgK, device=x.device) // K).expand(G, NgK)
    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, NgK)
    w = (gate_vals.reshape(G, NgK) * keep).to(x.dtype)
    safe_pos = torch.where(keep, pos_in_e, C - 1)
    contrib = torch.where(keep[..., None], xg[g_idx, tok_flat],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((G, E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((g_idx, e_flat, safe_pos), contrib, accumulate=True)

    # ---- expert FFN
    dt = x.dtype
    gh = torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(dt))
    uh = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(dt))
    y = torch.einsum("gecf,efd->gecd", F.silu(gh) * uh, params["w_down"].to(dt))

    # ---- combine back to tokens
    gathered = y[g_idx, e_flat, safe_pos] * w[..., None]
    out = torch.zeros((G, Ng, D), dtype=dt, device=x.device)
    out.index_put_((g_idx, tok_flat), gathered, accumulate=True)
    out = out.reshape(B, S, D)

    if cfg.n_shared_experts:
        out = out + layers.swiglu(params["shared"], x)
    return out, aux
