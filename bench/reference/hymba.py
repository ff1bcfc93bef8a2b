"""Plain reference of the program's Hymba (arXiv:2411.13676), float32.

Each layer runs sliding-window attention and a Mamba-1 mixer side by side
on the normed input, norms each output and adds their mean; then a SwiGLU
MLP. The program's departures from the published model are kept, since
the reference has to compute what the program computes: no meta tokens,
the window in every layer (no global layers), no KV sharing across
layers, a dt projection of rank ``dt_rank`` (``bench/configs``' file
says which). Decode reads and writes the program's cache layout: a ring
of keys and values (slot = position mod window), the scan state, and the
last ``conv_width - 1`` mixer inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.plain import (Precision, rmsnorm, rope, selective_scan,
                                   window_attention)


def _layer(p: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in p.items()}


def _conv(xs, kernel, tail):
    """Depthwise causal conv: xs (B,T,di), kernel (W,di), tail (B,W-1,di)
    the inputs before xs. Returns (out, the new tail)."""
    W, T = kernel.shape[0], xs.shape[1]
    xp = torch.cat([tail.to(xs.dtype), xs], 1)
    out = sum(xp[:, i:i + T] * kernel[i].float() for i in range(W))
    return out, xp[:, -(W - 1):]


def _mamba(p, h, cfg, prec, ssm, tail):
    di, n = cfg["d_inner"], cfg["ssm_state"]
    xs, z = prec.mm(h, p["w_in"]).split(di, dim=-1)
    xs, tail = _conv(xs, p["conv"], tail)
    xs = F.silu(xs)
    Bm, Cm = prec.mm(xs, p["w_bc"]).split(n, dim=-1)
    dt = F.softplus(prec.mm(prec.mm(xs, p["w_dt"]), p["w_dt_out"]) + p["dt_bias"].float())
    y, ssm = selective_scan(xs, dt, Bm, Cm, -torch.exp(p["A_log"].float()), ssm)
    y = (y + xs * p["D"].float()) * F.silu(z)
    return prec.mm(y, p["w_out"]), ssm, tail


def _attention(p, h, cfg, prec, pos, k_prev, v_prev, k_pos_prev):
    B, T, _ = h.shape
    H, Kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    theta = cfg["rope_theta"]
    q = rope(prec.mm(h, p["wq"]).reshape(B, T, H, hd), pos, theta)
    k = rope(prec.mm(h, p["wk"]).reshape(B, T, Kv, hd), pos, theta)
    v = prec.mm(h, p["wv"]).reshape(B, T, Kv, hd)
    kk = torch.cat([k_prev.float(), k], 1)
    vv = torch.cat([v_prev.float(), v], 1)
    o = window_attention(q, kk, vv, pos, torch.cat([k_pos_prev, pos]), cfg["sliding_window"])
    return prec.mm(o.reshape(B, T, H * hd), p["wo"]), k, v


def _run(params, tokens, cfg, prec, state, pos0):
    """The layers over ``tokens`` (B,T) at positions pos0.. from ``state``
    (the program's cache layout, or None for a prompt from nothing).
    Returns the final-normed hidden states and the state after them."""
    B, T = tokens.shape
    dev, eps = tokens.device, cfg["norm_eps"]
    di, W = cfg["d_inner"], cfg["conv_width"]
    pos = torch.arange(pos0, pos0 + T, device=dev)
    x = params["embed"]["table"][tokens].float()
    new = {"k": [], "v": [], "ssm": [], "conv": []}
    for i in range(cfg["n_layers"]):
        p = _layer(params["layers"], i)
        if state is None:
            C = 0
            k_prev = torch.zeros(B, 0, cfg["n_kv_heads"], cfg["head_dim"], device=dev)
            v_prev = k_prev
            ssm = torch.zeros(B, di, cfg["ssm_state"], device=dev)
            tail = torch.zeros(B, W - 1, di, device=dev)
        else:
            C = state["k"].shape[2]
            # the ring in order of position: positions pos0-C .. pos0-1
            order = torch.arange(pos0 - C, pos0, device=dev) % C
            k_prev, v_prev = state["k"][i][:, order], state["v"][i][:, order]
            ssm, tail = state["ssm"][i], state["conv"][i]
        k_pos_prev = torch.arange(pos0 - C, pos0, device=dev)
        h = rmsnorm(x, p["norm"]["scale"], eps)
        a, k, v = _attention(p["attn"], h, cfg, prec, pos, k_prev, v_prev, k_pos_prev)
        m, ssm, tail = _mamba(p["mamba"], h, cfg, prec, ssm, tail)
        a = rmsnorm(a, p["attn_out_norm"]["scale"], eps)
        m = rmsnorm(m, p["mamba_out_norm"]["scale"], eps)
        x = x + 0.5 * (a + m)
        h = rmsnorm(x, p["ffn_norm"]["scale"], eps)
        mlp = p["mlp"]
        x = x + prec.mm(F.silu(prec.mm(h, mlp["w_gate"])) * prec.mm(h, mlp["w_up"]),
                        mlp["w_down"])
        if state is not None:
            ring_k, ring_v = state["k"][i].float().clone(), state["v"][i].float().clone()
            slots = pos % C
            keep = slice(max(0, T - C), T)          # later positions overwrite earlier
            ring_k[:, slots[keep]] = k[:, keep]
            ring_v[:, slots[keep]] = v[:, keep]
            for key, val in (("k", ring_k), ("v", ring_v), ("ssm", ssm), ("conv", tail)):
                new[key].append(val)
    out_state = None if state is None else {k: torch.stack(v) for k, v in new.items()}
    return rmsnorm(x, params["final_norm"]["scale"], eps), out_state


def head(params, x, prec):
    """Logits of final-normed hidden states."""
    return prec.mm(x, params["lm_head"].T)


def prefill_last_logits(params, tokens, cfg, prec: Precision):
    """Last-position logits (B, V) of prompts ``tokens`` (B, S)."""
    x, _ = _run(params, tokens, cfg, prec, None, 0)
    return head(params, x[:, -1], prec)


def decode(params, tokens, cfg, prec: Precision, state, pos0: int):
    """Tokens (B, T) fed one at a time from position ``pos0`` onto the
    cache ``state``, computed at once: the final-normed hidden state at
    every position (B, T, D) and the cache after the last."""
    return _run(params, tokens, cfg, prec, state, pos0)
