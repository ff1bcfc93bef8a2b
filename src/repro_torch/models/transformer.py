"""Decoder-only transformer: the dense, MoE and MLA families of
``repro.models.transformer``.

  * GQA attention with optional QKV bias (qwen2, qwen2-moe), sliding
    window (danube), and MLA latent attention (deepseek-v2-lite);
  * dense SwiGLU FFN, or shared+routed MoE FFN (deepseek, qwen2-moe;
    ``models/moe.py``) after ``first_dense_layers`` dense layers;
  * stacked layer parameters (a leading ``layers`` axis, as the reference
    keeps them: ``dense_layers``, then ``moe_layers``), walked by a Python
    loop where the reference scans;
  * modality-stub inputs (musicgen frames / pixtral patches): the forward
    takes precomputed embeddings instead of token ids;
  * decode path with a KV (or MLA latent / SWA ring-buffer) cache,
    updated in place.

``loss`` is the reference's token loss plus 0.01 times the MoE layers'
aux loss. ``remat`` (default on, as in the reference) checkpoints each
block when autograd records (``torch.utils.checkpoint``, the counterpart
of ``jax.checkpoint``): the backward recomputes a block's activations
instead of keeping them. MLA has no kernel route: its k (qk dim 192 at
full width) and v (128) differ in width, which the reference's flash
wrapper cannot take either, so MLA with ``use_kernel=True`` raises.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, moe
from repro_torch.models.layers import weight
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (BATCH_AXES, constrain, decode_layer, layer_barrier,
                                         logits_sharded, merge_heads, proj, residual,
                                         split_heads, write_at)
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


def _stacks(cfg: ModelConfig) -> list[tuple[str, int, bool]]:
    """(parameter key, layers, use_moe) of each non-empty stack, in depth
    order: the leading dense layers, then the MoE layers."""
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.n_experts else 0
    stacks = [("dense_layers", cfg.n_layers - n_moe, False), ("moe_layers", n_moe, True)]
    return [s for s in stacks if s[1]]


# ------------------------------------------------------------ layer schemas
def attention_schema(cfg: ModelConfig) -> Schema:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    if cfg.use_mla:
        qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
        return {
            "wq": ParamDef((d, H * qk_dim), ("embed", "q_fused")),
            "w_dkv": ParamDef((d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                              ("embed", None)),
            "kv_norm": layers.rmsnorm_schema(cfg.kv_lora_rank)["scale"],
            "w_uk": ParamDef((cfg.kv_lora_rank, H * cfg.qk_nope_dim),
                             (None, "q_fused")),
            "w_uv": ParamDef((cfg.kv_lora_rank, H * cfg.v_head_dim),
                             (None, "q_fused")),
            "wo": ParamDef((H * cfg.v_head_dim, d), ("o_fused", "embed")),
        }
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


def block_schema(cfg: ModelConfig, use_moe: bool) -> Schema:
    sch: Schema = {
        "attn_norm": layers.rmsnorm_schema(cfg.d_model),
        "attn": attention_schema(cfg),
        "ffn_norm": layers.rmsnorm_schema(cfg.d_model),
    }
    if use_moe:
        sch["moe"] = moe.moe_schema(cfg)
    else:
        sch["mlp"] = layers.swiglu_schema(cfg.d_model, cfg.d_ff)
    return sch


def model_schema(cfg: ModelConfig) -> Schema:
    sch: Schema = {}
    if not cfg.stub_frontend:
        sch["embed"] = layers.embedding_schema(cfg.padded_vocab, cfg.d_model)
    for key, n, use_moe in _stacks(cfg):
        sch[key] = _stack(block_schema(cfg, use_moe), n)
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
    dt = x.dtype
    hd = cfg.resolved_head_dim
    q = proj(x, weight(params["wq"], dt))
    k = proj(x, weight(params["wk"], dt))
    v = proj(x, weight(params["wv"], dt))
    if cfg.qkv_bias:
        q = q + weight(params["bq"], dt)
        k = k + weight(params["bk"], dt)
        v = v + weight(params["bv"], dt)
    q = layers.apply_rope(split_heads(q, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = layers.apply_rope(split_heads(k, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    return q, k, split_heads(v, cfg.n_kv_heads, hd)


def _mla_q_latent(params, x, cfg: ModelConfig, positions):
    """MLA's query (B,S,H,nope+rope), its rope part rotated, and the new
    latents: the normed c_kv (B,S,rank) and the rotated shared k_rope head
    (B,S,1,rope)."""
    dt = x.dtype
    q = split_heads(proj(x, weight(params["wq"], dt)), cfg.n_heads,
                    cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q = torch.cat([q_nope, layers.apply_rope(q_rope, positions, cfg.rope_theta)], dim=-1)
    c_kv, k_rope = torch.split(proj(x, weight(params["w_dkv"], dt)),
                               [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    c_kv = layers.rmsnorm({"scale": params["kv_norm"]}, c_kv, cfg.norm_eps)
    k_rope = layers.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q, c_kv, k_rope


def _mla_kv(params, c_kv, k_rope, cfg: ModelConfig):
    """K (B,C,H,nope+rope) and V (B,C,H,v) rebuilt from latents c_kv
    (B,C,rank) and the shared k_rope head (B,C,1,rope)."""
    B, C, _ = c_kv.shape
    H, dt = cfg.n_heads, c_kv.dtype
    k_nope = split_heads(proj(c_kv, weight(params["w_uk"], dt)), H, cfg.qk_nope_dim)
    v = split_heads(proj(c_kv, weight(params["w_uv"], dt)), H, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(B, C, H, cfg.qk_rope_dim)], dim=-1)
    return k, v


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


@tracing.spanned("attn")
def attention_block(params, x, cfg: ModelConfig, positions, use_kernel=False):
    if cfg.use_mla:
        if use_kernel:
            raise ValueError(
                f"{cfg.name}: MLA attention has no kernel route: its k (qk dim "
                f"{cfg.qk_nope_dim + cfg.qk_rope_dim}) and v (dim {cfg.v_head_dim}) "
                f"differ in width, which the flash-attention kernel cannot take, "
                f"and the reference cannot take this route either "
                f"(repro/kernels/ops.py reshapes v to q's head dim); serve MLA "
                f"with use_kernel=False")
        q, c_kv, k_rope = _mla_q_latent(params, x, cfg, positions)
        k, v = _mla_kv(params, c_kv, k_rope, cfg)
        out = layers.attention(q, k, v, window=cfg.sliding_window,
                               scale=_mla_scale(cfg))
        return proj(merge_heads(out), weight(params["wo"], x.dtype))
    q, k, v = _qkv(params, x, cfg, positions)
    out = layers.attention(q, k, v, window=cfg.sliding_window,
                           use_kernel=use_kernel)
    out = constrain(merge_heads(out), BATCH_AXES, None, "model")
    return proj(out, weight(params["wo"], x.dtype))


def _ffn(params, h, cfg: ModelConfig):
    """The block's FFN on the normed h: (out, aux), aux 0.0 when dense."""
    if "moe" in params:
        return moe.moe_apply(params["moe"], h, cfg)
    return layers.swiglu(params["mlp"], h), 0.0


def block_apply(params, x, cfg: ModelConfig, positions, use_kernel: bool = False):
    """One block: attention, then the dense or MoE FFN -> (x, aux)."""
    h = layers.rmsnorm(params["attn_norm"], x, cfg.norm_eps)
    x = residual(x + attention_block(params["attn"], h, cfg, positions, use_kernel))
    h = layers.rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
    y, aux = _ffn(params, h, cfg)
    return residual(x + y), aux


def remat_apply(fn, remat: bool, *args):
    """``fn(*args)``, checkpointed when ``remat`` and autograd records (a
    serving call, under ``no_grad``, runs it as it is)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _head_table(params):
    table = params.get("lm_head")
    return params["embed"]["table"] if table is None else table


def _cache_update(cache: torch.Tensor, new: torch.Tensor, slot: int) -> torch.Tensor:
    """Write ``new`` (B, ...) at ``slot`` of the cache's axis 1, in place
    (the reference's ``dynamic_update_index_in_dim``, without the copy)."""
    return write_at(cache, new, 1, slot)


# ------------------------------------------------------------- full forward
class DecoderLM(nn.Module):
    """The dense, MoE and MLA decoder. Parameters are a nested dict of
    tensors passed to every call, as in the reference; the module holds
    the config and the schema."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.schema = model_schema(cfg)
        self.n_params = param_count(self.schema)

    # -------------------------------------------------------------- params
    def init(self, generator: torch.Generator, device="cuda") -> dict:
        return init_params(self.schema, generator, device)

    def _blocks(self, params):
        """Each layer's parameters in depth order, across both stacks, as
        views (decode)."""
        for key, n, _ in _stacks(self.cfg):
            for i in range(n):
                yield layer(params[key], i)

    # ------------------------------------------------------------- forward
    def hidden_states(self, params, inputs, *, use_kernel=False, remat=True):
        """inputs: token ids (B,S), or embeddings (B,S,D) for stubs ->
        (final hidden states, the MoE layers' summed aux loss)."""
        cfg = self.cfg
        dt = _dtype(cfg)
        with tracing.span("embed"):
            if cfg.stub_frontend:
                x = inputs.to(dt)
            else:
                x = layers.embed(params["embed"], inputs, dt)
            x = residual(x)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        aux_total = 0.0
        for key, _, _ in _stacks(cfg):
            for p in unstack(params[key]):
                with tracing.span("layer"):
                    x, aux = remat_apply(block_apply, remat, layer_barrier(p), x, cfg,
                                         positions, use_kernel)
                aux_total = aux_total + aux
        with tracing.span("head"):
            x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return x, aux_total

    @tracing.spanned("head")
    def _unembed(self, params, x):
        cfg = self.cfg
        logits = layers.unembed({"table": _head_table(params)}, x)
        if cfg.num_codebooks > 1:
            logits = split_heads(logits, cfg.num_codebooks, cfg.padded_vocab)
        return logits

    def logits(self, params, inputs, *, use_kernel=False, remat=True):
        x, aux = self.hidden_states(params, inputs, use_kernel=use_kernel,
                                    remat=remat)
        return logits_sharded(self._unembed(params, x)), aux

    def last_logits(self, params, inputs, *, use_kernel=False, remat=True):
        """Prefill entry point: logits at the LAST position only — the full
        (B, S, V) prefill logit tensor is never materialized."""
        x, _ = self.hidden_states(params, inputs, use_kernel=use_kernel,
                                  remat=remat)
        return logits_sharded(self._unembed(params, x[:, -1:]))

    def loss(self, params, batch, *, use_kernel=False, remat=True):
        """batch: {"inputs": ids|embeds, "labels": (B,S[,n_codebooks])}."""
        logits, aux = self.logits(params, batch["inputs"], use_kernel=use_kernel,
                                  remat=remat)
        return layers.cross_entropy(logits, batch["labels"]) + 0.01 * aux

    # -------------------------------------------------------------- decode
    def cache_spec(self, batch: int, max_len: int) -> dict:
        """Cache shapes and dtypes: K and V (a ring buffer when sliding
        window), or MLA's latents ``ckv`` and ``krope``."""
        cfg = self.cfg
        C = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        dt, L = _dtype(cfg), cfg.n_layers
        if cfg.use_mla:
            return {"ckv": ((L, batch, C, cfg.kv_lora_rank), dt),
                    "krope": ((L, batch, C, cfg.qk_rope_dim), dt)}
        shape = (L, batch, C, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": (shape, dt), "v": (shape, dt)}

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        return {k: torch.zeros(shape, dtype=dt, device=device)
                for k, (shape, dt) in self.cache_spec(batch, max_len).items()}

    @torch.no_grad()
    def decode_step(self, params, cache, pos: int, token_or_embed, *,
                    use_kernel=False):
        """One decode step. pos: tokens already in the cache. The cache is
        updated in place and returned; one layer index runs through the
        dense prefix and the MoE suffix."""
        cfg = self.cfg
        dt = _dtype(cfg)
        with tracing.span("embed"):
            if cfg.stub_frontend:
                x = token_or_embed.to(dt)                          # (B, 1, D)
            else:
                x = layers.embed_token(params["embed"], token_or_embed, dt)  # (B,1,D)
        positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        C = next(iter(cache.values())).shape[2]
        slot = pos % C if cfg.sliding_window > 0 else min(pos, C - 1)
        for i, p in enumerate(self._blocks(params)):
            with tracing.span("layer"):
                p = decode_layer(p, x)
                h = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
                attn_out = self._decode_attention(
                    p["attn"], h, cfg, positions, pos, slot, layer(cache, i))
                x = x + attn_out
                h = layers.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
                x = x + _ffn(p, h, cfg)[0]
        with tracing.span("head"):
            x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self._unembed(params, x), cache

    @tracing.spanned("attn")
    def _decode_attention(self, params, x, cfg, positions, pos, slot, cache):
        if cfg.use_mla:
            q, c_kv, k_rope = _mla_q_latent(params, x, cfg, positions)
            ckv_cache = _cache_update(cache["ckv"], c_kv[:, 0], slot)
            kr_cache = _cache_update(cache["krope"], k_rope[:, 0, 0], slot)
            # K and V rebuilt from every cached latent, each step.
            k, v = _mla_kv(params, ckv_cache, kr_cache[:, :, None, :], cfg)
            out = layers.decode_attention(q, k, v, pos, window=cfg.sliding_window,
                                          scale=_mla_scale(cfg))
            return proj(merge_heads(out), weight(params["wo"], x.dtype))
        q, k, v = _qkv(params, x, cfg, positions)
        k_cache = _cache_update(cache["k"], k[:, 0], slot)
        v_cache = _cache_update(cache["v"], v[:, 0], slot)
        out = layers.decode_attention(q, k_cache, v_cache, pos,
                                      window=cfg.sliding_window)
        return proj(merge_heads(out), weight(params["wo"], x.dtype))
