"""Decoder-only transformer: the dense GQA family of ``repro.models.transformer``.

  * GQA attention with optional QKV bias (qwen2) and sliding window
    (danube);
  * dense SwiGLU FFN;
  * stacked layer parameters (a leading ``layers`` axis, as the reference
    keeps them), walked by a Python loop where the reference scans;
  * modality-stub inputs (musicgen frames / pixtral patches): the forward
    takes precomputed embeddings instead of token ids;
  * decode path with a KV (or SWA ring-buffer) cache, updated in place.

Serving only: the reference's ``remat`` (a training memory trade) has no
role here and is dropped. MoE FFNs (``n_experts > 0``) and MLA latent
attention (``use_mla``) come with the MoE/MLA slice of the port.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (
    ParamDef,
    Schema,
    init_params,
    layer,
    normal_init,
    param_count,
)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _stack(schema: Schema, n: int) -> Schema:
    """Add a leading 'layers' axis to every leaf (stacked params)."""

    def rec(node):
        if isinstance(node, ParamDef):
            return ParamDef(
                (n,) + node.shape, ("layers",) + node.axes, node.init, node.dtype
            )
        return {k: rec(v) for k, v in node.items()}

    return rec(schema)


def _not_ported(cfg: ModelConfig) -> None:
    if cfg.use_mla or cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs and MLA attention are not ported yet; they "
            f"come with the MoE/MLA slice of repro_torch.models"
        )


# ------------------------------------------------------------ layer schemas
def attention_schema(cfg: ModelConfig) -> Schema:
    _not_ported(cfg)
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    sch: Schema = {
        "wq": ParamDef((d, H * hd), ("embed", "q_fused")),
        "wk": ParamDef((d, Kv * hd), ("embed", "kv_fused")),
        "wv": ParamDef((d, Kv * hd), ("embed", "kv_fused")),
        "wo": ParamDef((H * hd, d), ("o_fused", "embed")),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamDef((H * hd,), ("q_fused",), normal_init(0.0))
        sch["bk"] = ParamDef((Kv * hd,), ("kv_fused",), normal_init(0.0))
        sch["bv"] = ParamDef((Kv * hd,), ("kv_fused",), normal_init(0.0))
    return sch


def block_schema(cfg: ModelConfig) -> Schema:
    return {
        "attn_norm": layers.rmsnorm_schema(cfg.d_model),
        "attn": attention_schema(cfg),
        "ffn_norm": layers.rmsnorm_schema(cfg.d_model),
        "mlp": layers.swiglu_schema(cfg.d_model, cfg.d_ff),
    }


def model_schema(cfg: ModelConfig) -> Schema:
    _not_ported(cfg)
    sch: Schema = {}
    if not cfg.stub_frontend:
        sch["embed"] = layers.embedding_schema(cfg.padded_vocab, cfg.d_model)
    sch["dense_layers"] = _stack(block_schema(cfg), cfg.n_layers)
    sch["final_norm"] = layers.rmsnorm_schema(cfg.d_model)
    n_heads_out = max(cfg.num_codebooks, 1)
    if not cfg.tie_embeddings or cfg.stub_frontend:
        sch["lm_head"] = ParamDef(
            (n_heads_out * cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
            normal_init(0.02),
        )
    return sch


# ---------------------------------------------------------------- attention
def _qkv(params, x, cfg: ModelConfig, positions):
    """Projected, biased and rotated q (B,S,H,hd) and k (B,S,Kv,hd), and v."""
    B, S, _ = x.shape
    dt = x.dtype
    hd = cfg.resolved_head_dim
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = layers.apply_rope(q.reshape(B, S, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = layers.apply_rope(k.reshape(B, S, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, cfg.n_kv_heads, hd)


def attention_block(params, x, cfg: ModelConfig, positions, use_kernel=False):
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    out = layers.attention(q, k, v, window=cfg.sliding_window,
                           use_kernel=use_kernel)
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    return out @ params["wo"].to(x.dtype)


def block_apply(params, x, cfg: ModelConfig, positions, use_kernel: bool = False):
    h = layers.rmsnorm(params["attn_norm"], x, cfg.norm_eps)
    x = x + attention_block(params["attn"], h, cfg, positions, use_kernel)
    h = layers.rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
    return x + layers.swiglu(params["mlp"], h)


def _head_table(params):
    table = params.get("lm_head")
    return params["embed"]["table"] if table is None else table


def _cache_update(cache: torch.Tensor, new: torch.Tensor, slot: int) -> torch.Tensor:
    """Write ``new`` (B, ...) at ``slot`` of the cache's axis 1, in place
    (the reference's ``dynamic_update_index_in_dim``, without the copy)."""
    cache[:, slot] = new
    return cache


# ------------------------------------------------------------- full forward
class DecoderLM(nn.Module):
    """The dense decoder. Parameters are a nested dict of tensors passed to
    every call, as in the reference; the module holds the config and the
    schema."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.schema = model_schema(cfg)
        self.n_params = param_count(self.schema)

    # -------------------------------------------------------------- params
    def init(self, generator: torch.Generator, device="cuda") -> dict:
        return init_params(self.schema, generator, device)

    # ------------------------------------------------------------- forward
    @torch.no_grad()
    def hidden_states(self, params, inputs, *, use_kernel=False):
        """inputs: token ids (B,S), or embeddings (B,S,D) for stubs."""
        cfg = self.cfg
        dt = _dtype(cfg)
        if cfg.stub_frontend:
            x = inputs.to(dt)
        else:
            x = layers.embed(params["embed"], inputs, dt)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        stacked = params["dense_layers"]
        for i in range(cfg.n_layers):
            x = block_apply(layer(stacked, i), x, cfg, positions, use_kernel)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return x, 0.0

    def _unembed(self, params, x):
        cfg = self.cfg
        logits = layers.unembed({"table": _head_table(params)}, x)
        if cfg.num_codebooks > 1:
            B, S, _ = logits.shape
            logits = logits.reshape(B, S, cfg.num_codebooks, cfg.padded_vocab)
        return logits

    def logits(self, params, inputs, *, use_kernel=False):
        x, aux = self.hidden_states(params, inputs, use_kernel=use_kernel)
        return self._unembed(params, x), aux

    def last_logits(self, params, inputs, *, use_kernel=False):
        """Prefill entry point: logits at the LAST position only — the full
        (B, S, V) prefill logit tensor is never materialized."""
        x, _ = self.hidden_states(params, inputs, use_kernel=use_kernel)
        return self._unembed(params, x[:, -1:])

    # -------------------------------------------------------------- decode
    def cache_spec(self, batch: int, max_len: int) -> dict:
        """KV cache shapes and dtypes (ring buffer when sliding window)."""
        cfg = self.cfg
        C = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        shape = (cfg.n_layers, batch, C, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": (shape, _dtype(cfg)), "v": (shape, _dtype(cfg))}

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        return {k: torch.zeros(shape, dtype=dt, device=device)
                for k, (shape, dt) in self.cache_spec(batch, max_len).items()}

    @torch.no_grad()
    def decode_step(self, params, cache, pos: int, token_or_embed, *,
                    use_kernel=False):
        """One decode step. pos: tokens already in the cache. The cache is
        updated in place and returned."""
        cfg = self.cfg
        dt = _dtype(cfg)
        if cfg.stub_frontend:
            x = token_or_embed.to(dt)                          # (B, 1, D)
        else:
            x = layers.embed(params["embed"], token_or_embed, dt)  # (B,1,D)
        positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        C = cache["k"].shape[2]
        slot = pos % C if cfg.sliding_window > 0 else min(pos, C - 1)
        stacked = params["dense_layers"]
        for i in range(cfg.n_layers):
            p = layer(stacked, i)
            h = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
            attn_out = self._decode_attention(
                p["attn"], h, cfg, positions, pos, slot, layer(cache, i))
            x = x + attn_out
            h = layers.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
            x = x + layers.swiglu(p["mlp"], h)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self._unembed(params, x), cache

    def _decode_attention(self, params, x, cfg, positions, pos, slot, cache):
        B = x.shape[0]
        q, k, v = _qkv(params, x, cfg, positions)
        k_cache = _cache_update(cache["k"], k[:, 0], slot)
        v_cache = _cache_update(cache["v"], v[:, 0], slot)
        out = layers.decode_attention(q, k_cache, v_cache, pos,
                                      window=cfg.sliding_window)
        out = out.reshape(B, 1, cfg.n_heads * cfg.resolved_head_dim)
        return out @ params["wo"].to(x.dtype)
