"""RWKV-6 "Finch" [arXiv:2404.05892] — attention-free RNN LM.

The port of ``repro.models.rwkv6``. Per layer: a time-mix block (WKV6
recurrence with data-dependent decay) and a channel-mix block. The WKV6
state is (heads, head_dim, head_dim) per sequence — O(1) in sequence
length.

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(wdec_t))

With ``use_kernel`` the prefill (zero initial state) runs the
hand-written WKV6 kernel (``repro_torch.kernels.ops.wkv6``); decode, which
carries the state, stays on the scan. ``WKV_IMPL`` picks the plain path:
the per-step scan or the chunk-parallel form. ``loss`` and ``remat`` are
the decoder's (``transformer.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers, loops
from repro_torch.models.layers import weight
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (decode_layer, layer_barrier, logits_sharded,
                                         merge_heads, proj, residual, split_heads,
                                         unshard)
from repro_torch.models.params import (
    ParamDef,
    Schema,
    init_params,
    layer,
    normal_init,
    param_count,
    unstack,
)
from repro_torch import tracing
from repro_torch.models.transformer import _dtype, _stack, remat_apply

HEAD_DIM = 64
DECAY_LORA = 64

# WKV implementation of the plain path: "scan" (paper-faithful per-step
# recurrence, the baseline), "chunked" (flash-linear-attention chunk-parallel
# form), or "auto".
WKV_IMPL = "scan"


def set_wkv_impl(impl: str) -> None:
    global WKV_IMPL
    assert impl in ("scan", "chunked", "auto")
    WKV_IMPL = impl


def n_rwkv_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def timemix_schema(cfg: ModelConfig) -> Schema:
    d = cfg.d_model
    return {
        "mu_r": ParamDef((d,), ("embed",), normal_init(0.01)),
        "mu_k": ParamDef((d,), ("embed",), normal_init(0.01)),
        "mu_v": ParamDef((d,), ("embed",), normal_init(0.01)),
        "mu_w": ParamDef((d,), ("embed",), normal_init(0.01)),
        "mu_g": ParamDef((d,), ("embed",), normal_init(0.01)),
        "w_r": ParamDef((d, d), ("embed", "q_fused")),
        "w_k": ParamDef((d, d), ("embed", "q_fused")),
        "w_v": ParamDef((d, d), ("embed", "q_fused")),
        "w_g": ParamDef((d, d), ("embed", "q_fused")),
        "w_o": ParamDef((d, d), ("o_fused", "embed")),
        # data-dependent decay: w0 + tanh(x @ A) @ B  (low-rank lora)
        "w0": ParamDef((d,), ("embed",), normal_init(0.01)),
        "wA": ParamDef((d, DECAY_LORA), ("embed", None)),
        "wB": ParamDef((DECAY_LORA, d), (None, "embed")),
        "u": ParamDef((d,), ("embed",), normal_init(0.01)),   # bonus
        "ln_scale": ParamDef((d,), ("embed",), normal_init(0.01)),
    }


def channelmix_schema(cfg: ModelConfig) -> Schema:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_r": ParamDef((d,), ("embed",), normal_init(0.01)),
        "mu_k": ParamDef((d,), ("embed",), normal_init(0.01)),
        "w_r": ParamDef((d, d), ("embed", "q_fused")),
        "w_k": ParamDef((d, f), ("embed", "ffn")),
        "w_v": ParamDef((f, d), ("ffn", "embed")),
    }


def block_schema(cfg: ModelConfig) -> Schema:
    return {
        "tm_norm": layers.rmsnorm_schema(cfg.d_model),
        "tm": timemix_schema(cfg),
        "cm_norm": layers.rmsnorm_schema(cfg.d_model),
        "cm": channelmix_schema(cfg),
    }


def model_schema(cfg: ModelConfig) -> Schema:
    return {
        "embed": layers.embedding_schema(cfg.padded_vocab, cfg.d_model),
        "layers": _stack(block_schema(cfg), cfg.n_layers),
        "final_norm": layers.rmsnorm_schema(cfg.d_model),
        "lm_head": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                            normal_init(0.02)),
    }


# ------------------------------------------------------------------- blocks
def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _shift(x):
    """The previous position's input, zeros before the first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv6_scan(r, k, v, w, u, state):
    """The WKV6 recurrence over time (plain reference path).

    r,k,v,w: (B, S, H, N); u: (H, N); state: (B, H, N, N).
    Returns (y (B,S,H,N), final_state).
    """
    S = r.shape[1]
    ys = []
    for t in loops.trips(S, r):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]   # (B,H,N)
        kv = k_t[..., :, None] * v_t[..., None, :]                 # (B,H,N,N)
        ys.append(torch.einsum("bhi,bhij->bhj", r_t,
                               state + u[None, :, :, None] * kv))
        state = w_t[..., :, None] * state + kv
    return loops.stack(ys, S, dim=1), state


def wkv6_chunked(r, k, v, w, u, state, chunk: int = 64):
    """Chunk-parallel WKV6 (flash-linear-attention style).

    Within a chunk of length T_c, with per-channel decays w and cumulative
    products A_t = prod_{s<=t} w_s:

      S_end = diag(A_T) S_0 + sum_s diag(A_T / A_s) k_s v_s^T
      y_t   = (r_t A_{t-1}) . S_0
            + sum_{s<t} ((r_t A_{t-1} / A_s) . k_s) v_s      (masked matmul)
            + (r_t . u k_t) v_t                              (bonus diagonal)

    The inter-chunk state is carried by a loop over chunks; intra-chunk
    work is products of (T_c, N) blocks. fp32 throughout; 1/A stays bounded
    because |chunk| * max(-log w) stays small for trained decays.
    """
    B, S, H, N = r.shape
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk

    def reshape_c(t):
        return t.reshape(B, nc, chunk, H, N).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = (reshape_c(t) for t in (r, k, v, w))   # (nc,B,H,Tc,N)
    mask = torch.tril(torch.ones((chunk, chunk), device=r.device), -1)
    ys = []
    for c in loops.trips(nc, r):
        r_b, k_b, v_b, w_b = rc[c], kc[c], vc[c], wc[c]       # (B,H,Tc,N)
        logw = torch.log(torch.clamp(w_b, min=1e-38))
        A = torch.exp(torch.cumsum(logw, dim=2))              # A_t, inclusive
        A_prev = A / w_b                                      # A_{t-1}
        r_dec = r_b * A_prev
        k_inv = k_b / A
        # cross-chunk contribution
        y = torch.einsum("bhtn,bhnm->bhtm", r_dec, state)
        # intra-chunk pairwise (strictly causal)
        scores = torch.einsum("bhtn,bhsn->bhts", r_dec, k_inv)
        y = y + torch.einsum("bhts,bhsm->bhtm", scores * mask, v_b)
        # bonus diagonal
        diag = torch.einsum("bhtn,bhtn->bht", r_b, u[None, :, None, :] * k_b)
        y = y + diag[..., None] * v_b
        # state update
        state = A[:, :, -1, :, None] * state + torch.einsum(
            "bhsn,bhsm->bhnm", k_b * (A[:, :, -1:, :] / A), v_b)
        ys.append(y)
    # (nc, B, H, Tc, N) -> (B, S, H, N)
    y = loops.stack(ys, nc).permute(1, 0, 3, 2, 4).reshape(B, S, H, N)
    return y, state


@tracing.spanned("ssm")
def timemix(params, x, cfg: ModelConfig, state=None, x_prev=None,
            use_kernel: bool = False):
    """x: (B,S,D). state: (B,H,N,N) initial WKV state (decode) or None.

    Returns (out (B,S,D), final state, x[:, -1]). With use_kernel the
    zero-state path runs the WKV6 kernel; a carried state stays on the
    plain path.
    """
    B, S, D = x.shape
    H, N = n_rwkv_heads(cfg), HEAD_DIM
    dt = x.dtype
    f32 = torch.float32
    if x_prev is None:
        x_prev = _shift(x)
    xr = _lerp(x, x_prev, weight(params["mu_r"], dt))
    xk = _lerp(x, x_prev, weight(params["mu_k"], dt))
    xv = _lerp(x, x_prev, weight(params["mu_v"], dt))
    xw = _lerp(x, x_prev, weight(params["mu_w"], dt))
    xg = _lerp(x, x_prev, weight(params["mu_g"], dt))
    r = split_heads(proj(xr, weight(params["w_r"], dt)), H, N).to(f32)
    k = split_heads(proj(xk, weight(params["w_k"], dt)), H, N).to(f32)
    v = split_heads(proj(xv, weight(params["w_v"], dt)), H, N).to(f32)
    g = F.silu(proj(xg, weight(params["w_g"], dt)))
    # data-dependent decay in (0, 1)
    wdec = weight(params["w0"], f32) + proj(torch.tanh(
        proj(xw.to(f32), weight(params["wA"], f32))), weight(params["wB"], f32))
    w = split_heads(torch.exp(-torch.exp(wdec)), H, N)
    u = split_heads(weight(params["u"], f32), H, N)
    if state is None and use_kernel:
        from repro_torch.kernels import ops as kops

        y, state = kops.wkv6(r, k, v, w, u)
    else:
        if state is None:
            state = torch.zeros((B, H, N, N), dtype=f32, device=x.device)
        r, k, v, w = (unshard(t, 1) for t in (r, k, v, w))
        if WKV_IMPL in ("chunked", "auto") and S % 64 == 0 and S > 64:
            y, state = wkv6_chunked(r, k, v, w, u, state)
        else:
            y, state = wkv6_scan(r, k, v, w, u, state)
    y = merge_heads(y).to(dt)
    # per-head group norm (approximated by rms over head dim groups)
    y = layers.rmsnorm({"scale": params["ln_scale"]}, y, cfg.norm_eps)
    out = proj(y * g, weight(params["w_o"], dt))
    return out, state, x[:, -1]


@tracing.spanned("mlp")
def channelmix(params, x, cfg: ModelConfig, x_prev=None):
    dt = x.dtype
    if x_prev is None:
        x_prev = _shift(x)
    xr = _lerp(x, x_prev, weight(params["mu_r"], dt))
    xk = _lerp(x, x_prev, weight(params["mu_k"], dt))
    r = torch.sigmoid(proj(xr, weight(params["w_r"], dt)))
    k = torch.square(torch.relu(proj(xk, weight(params["w_k"], dt))))
    return r * proj(k, weight(params["w_v"], dt)), x[:, -1]


def block_apply(p, x, cfg: ModelConfig, use_kernel: bool = False):
    """One layer: the time-mix block, then the channel-mix block, each on
    its normed input and added to the residual."""
    h = layers.rmsnorm(p["tm_norm"], x, cfg.norm_eps)
    out, _, _ = timemix(p["tm"], h, cfg, use_kernel=use_kernel)
    x = x + out
    h = layers.rmsnorm(p["cm_norm"], x, cfg.norm_eps)
    out, _ = channelmix(p["cm"], h, cfg)
    return x + out


# -------------------------------------------------------------------- model
class RWKV6LM(nn.Module):
    """The RWKV-6 LM; parameters are passed to every call, as in the
    reference."""

    # decode_step never reads its position (the state carries it), so the
    # reference's jit drops that argument (launch/steps.py::make_cell).
    decode_reads_pos = False

    def __init__(self, cfg: ModelConfig):
        super().__init__()
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
        for p in unstack(params["layers"]):
            with tracing.span("layer"):
                x = residual(remat_apply(block_apply, remat, layer_barrier(p), x, cfg,
                                         use_kernel))
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
        H, N = n_rwkv_heads(cfg), HEAD_DIM
        L, D = cfg.n_layers, cfg.d_model
        return {
            "wkv": ((L, batch, H, N, N), torch.float32),
            "tm_prev": ((L, batch, D), _dtype(cfg)),
            "cm_prev": ((L, batch, D), _dtype(cfg)),
        }

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        return {k: torch.zeros(shape, dtype=dt, device=device)
                for k, (shape, dt) in self.cache_spec(batch, max_len).items()}

    @torch.no_grad()
    def decode_step(self, params, cache, pos: int, tokens, *, use_kernel=False):
        """One decode step (the WKV scan from the cached state); each
        layer's slice of the cache is updated in place and the cache
        returned. ``pos`` is unused: the state carries the position."""
        cfg = self.cfg
        with tracing.span("embed"):
            x = layers.embed_token(params["embed"], tokens, _dtype(cfg))    # (B,1,D)
        for i in range(cfg.n_layers):
            with tracing.span("layer"):
                p = decode_layer(layer(params["layers"], i), x)
                c = layer(cache, i)
                h = layers.rmsnorm(p["tm_norm"], x, cfg.norm_eps)
                out, wkv, tm_new = timemix(p["tm"], h, cfg, state=c["wkv"],
                                           x_prev=c["tm_prev"][:, None, :])
                c["wkv"].copy_(wkv)
                c["tm_prev"].copy_(tm_new)
                x = x + out
                h = layers.rmsnorm(p["cm_norm"], x, cfg.norm_eps)
                out, cm_new = channelmix(p["cm"], h, cfg,
                                         x_prev=c["cm_prev"][:, None, :])
                c["cm_prev"].copy_(cm_new)
                x = x + out
        with tracing.span("head"):
            x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
            logits = layers.unembed({"table": params["lm_head"]}, x)
        return logits, cache
