"""Core NN layers: norms, rotary embeddings, attention (naive / chunked /
decode), MLPs. Pure functions over schema-built param dicts; the port of
``repro.models.layers``.

Attention memory discipline: seq > CHUNK_THRESHOLD routes through a
two-level online-softmax (flash-style) implementation so a long prefill
never materializes an S^2 score tensor. ``use_kernel=True`` swaps in the
hand-written flash-attention kernel (``repro_torch.kernels.ops``).

On one device the reference's sharding hooks (``models/sharding.py``:
``constrain``, ``residual``, ``layer_barrier``, ``logits_sharded``) are
identities and are left out, as are the sequence-parallel
``sp_attention`` / ``sp_decode_attention``: they come with the multi-card
substrate.
"""
from __future__ import annotations

from fractions import Fraction

import torch
import torch.nn.functional as F

from repro_torch.models import loops
from repro_torch.models.params import ParamDef, normal_init, ones_init

# Above this sequence length attention always takes the online-softmax
# chunked path (never materialize a (B,H,S,S) fp32 score tensor).
CHUNK_THRESHOLD = 2048
Q_CHUNK = 1024
KV_CHUNK = 1024
NEG_INF = -1e30


# ------------------------------------------------------------------- norms
def rmsnorm_schema(dim: int) -> dict:
    return {"scale": ParamDef((dim,), ("embed",), ones_init())}


def rmsnorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dtype)


# ------------------------------------------------------------------ rotary
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Angles in
    fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                       # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (..., S, hd/2)
    angles = angles[..., None, :]                                 # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def _mask_bias(q_pos, k_pos, window: int):
    """Causal (+ sliding window) additive bias; shapes broadcast."""
    ok = q_pos[..., :, None] >= k_pos[..., None, :]
    if window > 0:
        ok = ok & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def naive_attention(q, k, v, *, window: int = 0, scale: float | None = None):
    """q: (B,S,H,hd), k/v: (B,S,Kv,hd) -> (B,S,H,hd). For short seqs."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    k = _repeat_kv(k, H // Kv)
    v = _repeat_kv(v, H // Kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    pos = torch.arange(S, device=q.device)
    scores = scores + _mask_bias(pos, pos, window)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q, k, v, *, window: int = 0, scale: float | None = None,
                      q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK):
    """Two-level online-softmax attention (flash-style, plain PyTorch).

    Never materializes more than (B, H, q_chunk, kv_chunk) of scores. The
    reference's ``lax.map``/``lax.scan`` over chunks are Python loops
    here; its ``q_offset`` serves only the sequence-parallel path. A key
    chunk wholly after a query chunk's last position is skipped: its
    scores are masked to -1e30 after a chunk with unmasked keys (key 0 is
    in every query's causal window when it comes first), so it would add
    exactly 0 to the sums and leave the running max as it is. Every
    (query chunk, key chunk) pair does the same products, so a loop-aware
    count (``models/loops.py``) takes one pair for all of them.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    Kv = k.shape[2]
    hd_v = v.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    assert Sq % q_chunk == 0 and Sk % kv_chunk == 0, (Sq, Sk, q_chunk, kv_chunk)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    groups = H // Kv

    qr = q.reshape(B, nq, q_chunk, H, hd).permute(1, 0, 3, 2, 4)   # (nq,B,H,qc,hd)
    kr = k.reshape(B, nk, kv_chunk, Kv, hd).permute(1, 0, 3, 2, 4)
    vr = v.reshape(B, nk, kv_chunk, Kv, hd_v).permute(1, 0, 3, 2, 4)
    # Key chunks each query chunk visits: all up to its last position.
    spans = [min(nk, -(-(qi + 1) * q_chunk // kv_chunk)) for qi in range(nq)]
    outs = []
    for qi in loops.trips(nq, q, nq):
        q_blk = qr[qi]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        acc = torch.zeros((B, H, q_chunk, hd_v), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        denom = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=q.device)
        for ki in loops.trips(spans[qi], q, Fraction(sum(spans), nq)):
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
            k_rep = torch.repeat_interleave(kr[ki], groups, dim=1)     # (B,H,kc,hd)
            v_rep = torch.repeat_interleave(vr[ki], groups, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", q_blk, k_rep).to(torch.float32) * scale
            s = s + _mask_bias(q_pos, k_pos, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            denom = denom * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(q.dtype), v_rep).to(torch.float32)
            m = m_new
        out = acc / torch.clamp(denom[..., None], min=1e-30)
        outs.append(out.to(q.dtype))                                # (B,H,qc,hd)
    # (nq,B,H,qc,hd_v) -> (B, Sq, H, hd_v)
    return loops.stack(outs, nq).permute(1, 0, 3, 2, 4).reshape(B, Sq, H, hd_v)


def attention(q, k, v, *, window: int = 0, scale: float | None = None,
              use_kernel: bool = False):
    """The reference's ``attention(use_pallas=)``: the flash kernel with
    ``use_kernel``, else chunked above CHUNK_THRESHOLD, else naive."""
    if use_kernel:
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, window=window, scale=scale)
    if q.shape[1] > CHUNK_THRESHOLD:
        return chunked_attention(q, k, v, window=window, scale=scale)
    return naive_attention(q, k, v, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0,
                     scale: float | None = None):
    """One-token attention against a cache.

    q: (B, 1, H, hd); k/v_cache: (B, C, Kv, hd); pos: current index
    (number of tokens already in cache, 0-based insert position).
    For sliding windows the cache is a ring buffer of capacity C=window and
    slot validity is derived from pos.
    """
    B, C, Kv, hd = k_cache.shape
    H = q.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    k = _repeat_kv(k_cache, H // Kv)
    v = _repeat_kv(v_cache, H // Kv)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    slot = torch.arange(C, device=q.device)
    if window > 0 and pos >= C:
        valid = torch.ones_like(slot, dtype=torch.bool)   # after wrap, all
    elif window > 0:
        valid = slot <= min(pos, C - 1)
    else:
        valid = slot <= pos
    s = torch.where(valid[None, None, None, :], s,
                    torch.full((), NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# -------------------------------------------------------------------- MLPs
def swiglu_schema(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed", "ffn")),
        "w_up": ParamDef((d_model, d_ff), ("embed", "ffn")),
        "w_down": ParamDef((d_ff, d_model), ("ffn", "embed")),
    }


def swiglu(params, x):
    dtype = x.dtype
    g = x @ params["w_gate"].to(dtype)
    u = x @ params["w_up"].to(dtype)
    h = F.silu(g) * u
    return h @ params["w_down"].to(dtype)


# --------------------------------------------------------------- embedding
def embedding_schema(vocab: int, d_model: int) -> dict:
    return {"table": ParamDef((vocab, d_model), ("vocab", "embed"),
                              normal_init(0.02))}


def embed(params, ids, dtype):
    # Gather, then cast: the same values as the reference's cast-then-
    # gather, without casting the whole table.
    return params["table"][ids].to(dtype)


def unembed(params, x, table=None):
    t = (table if table is not None else params["table"]).to(x.dtype)
    return x @ t.T


# -------------------------------------------------------------------- loss
def cross_entropy(logits, labels):
    """The reference models' token loss: fp32 log-softmax, positions whose
    label is negative masked, the mean over the rest. logits (..., V),
    labels (...) of any integer dtype."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
