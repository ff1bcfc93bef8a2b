"""Plain reference of the program's RWKV-6 "Finch" (arXiv:2404.05892),
float32.

Each layer: a time-mix block (token shift by a static lerp, the WKV6
recurrence with a data-dependent decay through a rank-``decay_lora``
projection, a bonus ``u``, a norm over the whole width, a SiLU gate) and a
channel-mix block (squared ReLU key, sigmoid receptance), each on its
normed input and added to the residual. The program's departures from the
published model are kept (``bench/configs``' file lists them). Decode
reads and writes the program's cache layout: the WKV state of every head
and the previous token's normed input of each block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.plain import Precision, rmsnorm, wkv6

HEAD_DIM = 64


def _layer(p: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in p.items()}


def _shifted(h, prev):
    """The previous position's input: ``prev`` (B, D) before the first."""
    return torch.cat([prev[:, None].to(h.dtype), h[:, :-1]], 1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.float()


def _timemix(p, h, cfg, prec, S, prev):
    B, T, D = h.shape
    H, N = D // HEAD_DIM, HEAD_DIM
    hp = _shifted(h, prev)
    r, k, v = (prec.mm(_lerp(h, hp, p[f"mu_{c}"]), p[f"w_{c}"]).reshape(B, T, H, N)
               for c in "rkv")
    g = F.silu(prec.mm(_lerp(h, hp, p["mu_g"]), p["w_g"]))
    wdec = p["w0"].float() + prec.mm(torch.tanh(prec.mm(_lerp(h, hp, p["mu_w"]), p["wA"])),
                                     p["wB"])
    w = torch.exp(-torch.exp(wdec)).reshape(B, T, H, N)
    y, S = wkv6(r, k, v, w, p["u"].float().reshape(H, N), S)
    y = rmsnorm(y.reshape(B, T, D), p["ln_scale"], cfg["norm_eps"])
    return prec.mm(y * g, p["w_o"]), S, h[:, -1]


def _channelmix(p, h, prec, prev):
    hp = _shifted(h, prev)
    r = torch.sigmoid(prec.mm(_lerp(h, hp, p["mu_r"]), p["w_r"]))
    k = torch.relu(prec.mm(_lerp(h, hp, p["mu_k"]), p["w_k"])).square()
    return r * prec.mm(k, p["w_v"]), h[:, -1]


def _run(params, tokens, cfg, prec, state):
    B, T = tokens.shape
    D, eps, dev = cfg["d_model"], cfg["norm_eps"], tokens.device
    H = D // HEAD_DIM
    x = params["embed"]["table"][tokens].float()
    new = {"wkv": [], "tm_prev": [], "cm_prev": []}
    for i in range(cfg["n_layers"]):
        p = _layer(params["layers"], i)
        if state is None:
            S = torch.zeros(B, H, HEAD_DIM, HEAD_DIM, device=dev)
            tm_prev = cm_prev = torch.zeros(B, D, device=dev)
        else:
            S, tm_prev, cm_prev = (state[k][i] for k in ("wkv", "tm_prev", "cm_prev"))
        h = rmsnorm(x, p["tm_norm"]["scale"], eps)
        out, S, tm_last = _timemix(p["tm"], h, cfg, prec, S, tm_prev)
        x = x + out
        h = rmsnorm(x, p["cm_norm"]["scale"], eps)
        out, cm_last = _channelmix(p["cm"], h, prec, cm_prev)
        x = x + out
        for key, val in (("wkv", S), ("tm_prev", tm_last), ("cm_prev", cm_last)):
            new[key].append(val)
    out_state = None if state is None else {k: torch.stack(v) for k, v in new.items()}
    return rmsnorm(x, params["final_norm"]["scale"], eps), out_state


def head(params, x, prec):
    """Logits of final-normed hidden states."""
    return prec.mm(x, params["lm_head"].T)


def prefill_last_logits(params, tokens, cfg, prec: Precision):
    """Last-position logits (B, V) of prompts ``tokens`` (B, S)."""
    x, _ = _run(params, tokens, cfg, prec, None)
    return head(params, x[:, -1], prec)


def decode(params, tokens, cfg, prec: Precision, state, pos0: int):
    """Tokens (B, T) fed one at a time onto the cache ``state``, computed
    at once: the final-normed hidden state at every position (B, T, D) and
    the cache after the last. The state carries the position, so ``pos0``
    is not read."""
    return _run(params, tokens, cfg, prec, state)
