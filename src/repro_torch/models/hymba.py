"""Hymba [arXiv:2411.13676] — hybrid-head LM: parallel attention + Mamba.

The port of ``repro.models.hymba``. Each layer runs a (sliding-window)
attention head group and a Mamba (SSM) head group *in parallel* on the
same input, normalizes each output, and averages them. Meta-tokens are
omitted, as in the reference.

The Mamba side keeps O(1) decode state (conv tail + SSM state), and the
attention side uses a ring-buffer SWA cache. With ``use_kernel`` the
prefill runs the hand-written flash-attention, causal-conv and gated
selective-scan kernels (``repro_torch.kernels.ops``); decode stays on the
plain recurrence.
``loss`` and ``remat`` are the decoder's (``transformer.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers, loops
from repro_torch.models.layers import weight
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (decode_layer, layer_barrier, logits_sharded,
                                         merge_heads, proj, residual)
from repro_torch.models.params import (
    ParamDef,
    Schema,
    init_params,
    layer,
    normal_init,
    ones_init,
    param_count,
    unstack,
    zeros_init,
)
from repro_torch.models.transformer import (
    _cache_update,
    _dtype,
    _qkv,
    _stack,
    attention_block,
    attention_schema,
    remat_apply,
)
from repro_torch import tracing

SWA_WINDOW = 1024
DT_RANK = 48


def d_inner(cfg: ModelConfig) -> int:
    return cfg.d_inner or 2 * cfg.d_model


# ------------------------------------------------------------------- mamba
def mamba_schema(cfg: ModelConfig) -> Schema:
    d = cfg.d_model
    di = d_inner(cfg)
    n = cfg.ssm_state
    return {
        "w_in": ParamDef((d, 2 * di), ("embed", "ffn")),
        "conv": ParamDef((cfg.conv_width, di), ("conv", "ffn"),
                         normal_init(0.1)),
        "w_bc": ParamDef((di, 2 * n), ("ffn", None)),
        "w_dt": ParamDef((di, DT_RANK), ("ffn", None)),
        "w_dt_out": ParamDef((DT_RANK, di), (None, "ffn")),
        "dt_bias": ParamDef((di,), ("ffn",), zeros_init()),
        "A_log": ParamDef((di, n), ("ffn", "state"), normal_init(0.1)),
        "D": ParamDef((di,), ("ffn",), ones_init()),
        "w_out": ParamDef((di, d), ("ffn", "embed")),
    }


def _causal_conv(x, kernel, conv_state=None):
    """Depthwise causal conv1d. x: (B,S,di); kernel: (W,di).

    conv_state: (B, W-1, di) tail of previous inputs (decode) or None.
    Returns (y, new_conv_state).
    """
    W = kernel.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+W-1, di)
    y = xp[:, 0:x.shape[1], :] * kernel[0][None, None, :]
    for i in range(1, W):
        y = y + xp[:, i:i + x.shape[1], :] * kernel[i][None, None, :]
    return y, xp[:, -(W - 1):, :]


def _mixer_kernels(params, xz, cfg: ModelConfig, conv_state):
    """The zero-state mixer after its in-projection through the two kernels
    either side of its projections: the causal conv with its SiLU, then the
    gated scan (dt's bias and softplus, the scan, the D skip and the
    ``silu(z)`` gate). Both read xz's halves in place, and the scan reads
    bc's."""
    from repro_torch.kernels import ops as kops

    dt_ = xz.dtype
    di, n = d_inner(cfg), cfg.ssm_state
    xs, conv_state = kops.causal_conv_silu(xz[..., :di], weight(params["conv"], dt_),
                                           conv_state)
    bc = proj(xs, weight(params["w_bc"], dt_))
    dt_raw = proj(proj(xs, weight(params["w_dt"], dt_)), weight(params["w_dt_out"], dt_))
    A = -torch.exp(weight(params["A_log"], torch.float32))
    y, state = kops.mamba_scan_gated(xs, dt_raw, bc[..., :n], bc[..., n:], A,
                                     weight(params["dt_bias"], torch.float32),
                                     weight(params["D"], dt_), xz[..., di:])
    return proj(y, weight(params["w_out"], dt_)), state, conv_state


@tracing.spanned("ssm")
def mamba_mixer(params, x, cfg: ModelConfig, state=None, conv_state=None,
                use_kernel: bool = False):
    """Selective SSM. x: (B,S,D). state: (B,di,n) or None.

    Returns (out (B,S,D), new_state, new_conv_state). With use_kernel the
    zero-state path runs the causal-conv and gated-scan kernels
    (``_mixer_kernels``); decode (state given) stays on the scan.
    """
    B, S, D = x.shape
    dt_ = x.dtype
    di = d_inner(cfg)
    n = cfg.ssm_state
    xz = proj(x, weight(params["w_in"], dt_))
    if use_kernel and state is None:
        return _mixer_kernels(params, xz, cfg, conv_state)
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs, conv_state = _causal_conv(xs, weight(params["conv"], dt_), conv_state)
    xs = F.silu(xs)
    bc = proj(xs, weight(params["w_bc"], dt_))
    B_ssm, C_ssm = torch.chunk(bc, 2, dim=-1)            # (B,S,n)
    dt_raw = proj(proj(xs, weight(params["w_dt"], dt_)), weight(params["w_dt_out"], dt_))
    dt = F.softplus(
        dt_raw.to(torch.float32) + weight(params["dt_bias"], torch.float32)
    )                                                   # (B,S,di)
    A = -torch.exp(weight(params["A_log"], torch.float32))   # (di,n)
    if state is None:
        state = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)

    # Discretize inside the step (never a (B,S,di,n) tensor), as the
    # reference's scan does; the scan is a Python loop over time.
    xs32 = xs.to(torch.float32)
    Bs = B_ssm.to(torch.float32)
    Cs = C_ssm.to(torch.float32)
    ys = []
    for t in loops.trips(S, x):
        dt_t, B_t, C_t = dt[:, t], Bs[:, t], Cs[:, t]
        dA_t = torch.exp(dt_t[:, :, None] * A[None])            # (B,di,n)
        dBx_t = dt_t[:, :, None] * B_t[:, None, :] * xs32[:, t, :, None]
        state = dA_t * state + dBx_t
        ys.append(torch.einsum("bdn,bn->bd", state, C_t))
    y = loops.stack(ys, S, dim=1).to(dt_)                # (B,S,di)
    y = y + xs * weight(params["D"], dt_)
    y = y * F.silu(z)
    return proj(y, weight(params["w_out"], dt_)), state, conv_state


# ------------------------------------------------------------------- layer
def block_schema(cfg: ModelConfig) -> Schema:
    return {
        "norm": layers.rmsnorm_schema(cfg.d_model),
        "attn": attention_schema(cfg),
        "attn_out_norm": layers.rmsnorm_schema(cfg.d_model),
        "mamba": mamba_schema(cfg),
        "mamba_out_norm": layers.rmsnorm_schema(cfg.d_model),
        "ffn_norm": layers.rmsnorm_schema(cfg.d_model),
        "mlp": layers.swiglu_schema(cfg.d_model, cfg.d_ff),
    }


def model_schema(cfg: ModelConfig) -> Schema:
    return {
        "embed": layers.embedding_schema(cfg.padded_vocab, cfg.d_model),
        "layers": _stack(block_schema(cfg), cfg.n_layers),
        "final_norm": layers.rmsnorm_schema(cfg.d_model),
        "lm_head": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                            normal_init(0.02)),
    }


def block_apply(p, x, cfg: ModelConfig, positions, use_kernel: bool = False):
    """One layer: attention and the Mamba mixer in parallel on the normed
    input, each output normed, their mean added; then the SwiGLU FFN."""
    h = layers.rmsnorm(p["norm"], x, cfg.norm_eps)
    a = attention_block(p["attn"], h, cfg, positions, use_kernel)
    m, _, _ = mamba_mixer(p["mamba"], h, cfg, use_kernel=use_kernel)
    a = layers.rmsnorm(p["attn_out_norm"], a, cfg.norm_eps)
    m = layers.rmsnorm(p["mamba_out_norm"], m, cfg.norm_eps)
    x = x + 0.5 * (a + m)
    h = layers.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    return x + layers.swiglu(p["mlp"], h)


class HymbaLM(nn.Module):
    """The hybrid-head LM; parameters are passed to every call, as in the
    reference."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.sliding_window == 0:
            cfg = dataclasses.replace(cfg, sliding_window=SWA_WINDOW)
        self.cfg = cfg
        self.schema = model_schema(cfg)
        self.n_params = param_count(self.schema)

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        return init_params(self.schema, generator, device)

    # ------------------------------------------------------------- forward
    def hidden_states(self, params, tokens, *, use_kernel=False, remat=True):
        cfg = self.cfg
        with tracing.span("embed"):
            x = residual(layers.embed(params["embed"], tokens, _dtype(cfg)))
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        for p in unstack(params["layers"]):
            with tracing.span("layer"):
                x = residual(remat_apply(block_apply, remat, layer_barrier(p), x, cfg,
                                         positions, use_kernel))
        with tracing.span("head"):
            return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps), 0.0

    def logits(self, params, tokens, *, use_kernel=False, remat=True):
        x, aux = self.hidden_states(params, tokens, use_kernel=use_kernel,
                                    remat=remat)
        with tracing.span("head"):
            return logits_sharded(layers.unembed({"table": params["lm_head"]}, x)), aux

    def last_logits(self, params, tokens, *, use_kernel=False, remat=True):
        x, _ = self.hidden_states(params, tokens, use_kernel=use_kernel,
                                  remat=remat)
        with tracing.span("head"):
            return logits_sharded(layers.unembed({"table": params["lm_head"]}, x[:, -1:]))

    def loss(self, params, batch, *, use_kernel=False, remat=True):
        logits, _ = self.logits(params, batch["inputs"], use_kernel=use_kernel,
                                remat=remat)
        return layers.cross_entropy(logits, batch["labels"])

    # -------------------------------------------------------------- decode
    def cache_spec(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        C = min(max_len, cfg.sliding_window)
        L, hd, di = cfg.n_layers, cfg.resolved_head_dim, d_inner(cfg)
        dt = _dtype(cfg)
        return {
            "k": ((L, batch, C, cfg.n_kv_heads, hd), dt),
            "v": ((L, batch, C, cfg.n_kv_heads, hd), dt),
            "ssm": ((L, batch, di, cfg.ssm_state), torch.float32),
            "conv": ((L, batch, cfg.conv_width - 1, di), dt),
        }

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        return {k: torch.zeros(shape, dtype=dt, device=device)
                for k, (shape, dt) in self.cache_spec(batch, max_len).items()}

    @torch.no_grad()
    def decode_step(self, params, cache, pos: int, tokens, *, use_kernel=False):
        """One decode step; the cache is updated in place and returned."""
        cfg = self.cfg
        dt = _dtype(cfg)
        with tracing.span("embed"):
            x = layers.embed_token(params["embed"], tokens, dt)
        positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        slot = pos % cache["k"].shape[2]
        for i in range(cfg.n_layers):
            with tracing.span("layer"):
                p = decode_layer(layer(params["layers"], i), x)
                c = layer(cache, i)
                h = layers.rmsnorm(p["norm"], x, cfg.norm_eps)
                # --- attention side (ring-buffer SWA cache)
                with tracing.span("attn"):
                    ap = p["attn"]
                    q, k, v = _qkv(ap, h, cfg, positions)
                    k_c = _cache_update(c["k"], k[:, 0], slot)
                    v_c = _cache_update(c["v"], v[:, 0], slot)
                    a = layers.decode_attention(q, k_c, v_c, pos,
                                                window=cfg.sliding_window)
                    a = proj(merge_heads(a), weight(ap["wo"], dt))
                # --- mamba side
                m, ssm, conv = mamba_mixer(p["mamba"], h, cfg, state=c["ssm"],
                                           conv_state=c["conv"])
                c["ssm"].copy_(ssm)
                c["conv"].copy_(conv)
                a = layers.rmsnorm(p["attn_out_norm"], a, cfg.norm_eps)
                m = layers.rmsnorm(p["mamba_out_norm"], m, cfg.norm_eps)
                x = x + 0.5 * (a + m)
                hh = layers.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
                x = x + layers.swiglu(p["mlp"], hh)
        with tracing.span("head"):
            x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
            logits = layers.unembed({"table": params["lm_head"]}, x)
        return logits, cache
