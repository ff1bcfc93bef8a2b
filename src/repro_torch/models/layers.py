"""Core NN layers: norms, rotary embeddings, attention (naive / chunked /
decode), MLPs. Pure functions over schema-built param dicts; the port of
``repro.models.layers``.

Attention memory discipline: seq > CHUNK_THRESHOLD routes through a
two-level online-softmax (flash-style) implementation so a long prefill
never materializes an S^2 score tensor. ``use_kernel=True`` swaps in the
hand-written flash-attention kernel (``repro_torch.kernels.ops``).

With a mesh in scope (``core/spmd.use_mesh``) and the knob's
``sp_attention`` on, ``attention`` takes the sequence-parallel
``sp_attention`` under sequence sharding and ``decode_attention`` takes
``sp_decode_attention`` over a sequence-sharded cache, each a
``spmd.shard_map`` over the mesh's virtual ranks. A body sees every
rank's block at once (the mesh dims lead); it treats them as leading
batch dims, broadcast where a block is replicated, so a gathered K/V
stays one expanded view.
"""
from __future__ import annotations

from fractions import Fraction

import torch
import torch.nn.functional as F

from repro_torch.core import spmd
from repro_torch.models import loops
from repro_torch.models import sharding as shd
from repro_torch.models.params import ParamDef, normal_init, ones_init
from repro_torch import tracing

# Above this sequence length attention always takes the online-softmax
# chunked path (never materialize a (B,H,S,S) fp32 score tensor).
CHUNK_THRESHOLD = 2048
Q_CHUNK = 1024
KV_CHUNK = 1024
NEG_INF = -1e30


# ----------------------------------------------------------------- weights
def weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.to(dtype)`` for a parameter leaf. While a profiler records, a
    cast that changes the dtype is a ``cast.weight`` span; a no-op cast
    opens none."""
    if tracing.profiling() and w.dtype != dtype:
        with tracing.span("cast.weight"):
            return w.to(dtype)
    return w.to(dtype)


# ------------------------------------------------------------------- norms
def rmsnorm_schema(dim: int) -> dict:
    return {"scale": ParamDef((dim,), ("embed",), ones_init())}


def rmsnorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight(params["scale"], torch.float32)).to(dtype)


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
    return torch.repeat_interleave(k, groups, dim=-2)


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
                      q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK,
                      q_offset=0):
    """Two-level online-softmax attention (flash-style, plain PyTorch).

    q (..., Sq, H, hd), k/v (..., Sk, Kv, hd) -> (..., Sq, H, hd_v): the
    leading dims broadcast (the sequence-parallel bodies give q one block
    per rank and K/V one gathered view for all). ``q_offset``: global
    position of q[..., 0, :, :], an int or a tensor broadcasting over the
    leading dims (one offset per rank). Never materializes more than
    (..., H, q_chunk, kv_chunk) of scores. The reference's
    ``lax.map``/``lax.scan`` over chunks are Python loops here. With an
    int offset, a key chunk wholly after a query chunk's last position is
    skipped: its scores are masked to -1e30 after a chunk with unmasked
    keys (the query's own position comes first), so it would add exactly
    0 to the sums and leave the running max as it is. A chunk wholly
    before a query chunk's window is not skipped: it is masked in full,
    its p is exp(0) = 1 against a running max of -1e30, and the next
    chunk's alpha = exp(-1e30 - m) = 0 wipes it out, as in the reference.
    Every (query chunk, key chunk) pair does the same products, so a
    loop-aware count (``models/loops.py``) takes one pair for all of them.
    """
    # A DTensor cut along the sequence is gathered first: the chunk loop
    # indexes it (XLA's partitioner reshards the reference's the same way).
    q, k, v = (shd.unshard(t, -3) for t in (q, k, v))
    *lead, Sq, H, hd = q.shape
    *lead_k, Sk, Kv, _ = k.shape
    hd_v = v.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    assert Sq % q_chunk == 0 and Sk % kv_chunk == 0, (Sq, Sk, q_chunk, kv_chunk)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    groups = H // Kv
    n = len(lead)

    def chunks(x, c, heads, d):
        # (..., S, heads, d) -> (S/c, ..., heads, c, d)
        x = x.reshape(*x.shape[:-3], x.shape[-3] // c, c, heads, d)
        return x.movedim(-4, 0).transpose(-3, -2)

    qr, kr, vr = chunks(q, q_chunk, H, hd), chunks(k, kv_chunk, Kv, hd), \
        chunks(v, kv_chunk, Kv, hd_v)
    if isinstance(q_offset, torch.Tensor):
        # one offset per leading index: (..., 1 [heads], 1 [queries])
        q_offset = q_offset.reshape(*q_offset.shape, *[1] * (n - q_offset.ndim), 1, 1)
        spans = [nk] * nq
    else:
        # Key chunks each query chunk visits: all up to its last position.
        spans = [min(nk, -(-(q_offset + (qi + 1) * q_chunk) // kv_chunk))
                 for qi in range(nq)]
    outs = []
    for qi in loops.trips(nq, q, nq):
        q_blk = qr[qi]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=q.device)
        acc = torch.zeros((*lead, H, q_chunk, hd_v), dtype=torch.float32, device=q.device)
        m = torch.full((*lead, H, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        denom = torch.zeros((*lead, H, q_chunk), dtype=torch.float32, device=q.device)
        for ki in loops.trips(spans[qi], q, Fraction(sum(spans), nq)):
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
            k_rep = torch.repeat_interleave(kr[ki], groups, dim=-3)    # (...,H,kc,hd)
            v_rep = torch.repeat_interleave(vr[ki], groups, dim=-3)
            s = torch.einsum("...hqd,...hkd->...hqk", q_blk, k_rep).to(torch.float32) * scale
            s = s + _mask_bias(q_pos, k_pos, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            denom = denom * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "...hqk,...hkd->...hqd", p.to(q.dtype), v_rep).to(torch.float32)
            m = m_new
        out = acc / torch.clamp(denom[..., None], min=1e-30)
        outs.append(out.to(q.dtype))                                # (...,H,qc,hd_v)
    # (nq, ..., H, qc, hd_v) -> (..., Sq, H, hd_v)
    out = loops.stack(outs, nq).transpose(-3, -2).movedim(0, -4)
    return out.reshape(*lead, Sq, H, hd_v)


def _mesh_dims(mesh) -> tuple[tuple[str, ...], int, int]:
    """The mesh's batch axes among ("pod", "data"), their total size, and
    the size of its model axis."""
    batch_axes = tuple(a for a in shd.BATCH_AXES if a in mesh.axis_names)
    dp = 1
    for a in batch_axes:
        dp *= mesh.axis_size(a)
    return batch_axes, dp, mesh.axis_size(shd.MODEL_AXIS)


def _rank_offsets(n_block_dims: int, step: int) -> torch.Tensor:
    """``axis_index("model") * step`` shaped to lead a block of
    ``n_block_dims`` dims (inside a body)."""
    idx = spmd.axis_index(shd.MODEL_AXIS) * step
    return idx.reshape(*idx.shape, *[1] * n_block_dims)


def sp_attention(q, k, v, *, window: int = 0, scale: float | None = None):
    """Sequence-parallel attention: an explicit shard_map over the mesh.

    q/k/v arrive seq-sharded over 'model'. Each rank all-gathers K/V (one
    expanded view here: no copy per rank) and runs the online-softmax
    loop on its LOCAL q shard with its global position offset."""
    spmd.count("sp_attention")
    mesh = shd._current_mesh()
    batch_axes, _, ep = _mesh_dims(mesh)
    S_l = q.shape[1] // ep

    def body(q_l, k_l, v_l):
        k_f = spmd.all_gather(k_l, shd.MODEL_AXIS, dim=1, tiled=True)
        v_f = spmd.all_gather(v_l, shd.MODEL_AXIS, dim=1, tiled=True)
        q_offset = _rank_offsets(1, S_l)                  # (*mesh, 1 [batch])
        return chunked_attention(
            q_l, k_f, v_f, window=window, scale=scale, q_offset=q_offset,
            q_chunk=min(Q_CHUNK, S_l),
        )

    spec = spmd.P(batch_axes if batch_axes else None, shd.MODEL_AXIS, None, None)
    return spmd.shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)


def _sp_attention_applicable(q, k) -> bool:
    from repro_torch.launch.knobs import active

    if not active().sp_attention or shd.seq_axis() != shd.MODEL_AXIS:
        return False
    mesh = shd._current_mesh()
    if mesh is None or shd.MODEL_AXIS not in mesh.axis_names:
        return False
    _, dp, ep = _mesh_dims(mesh)
    return (
        q.shape[1] % ep == 0
        and q.shape[0] % dp == 0
        and (q.shape[1] // ep) >= 128
    )


@tracing.spanned("attn.core")
def attention(q, k, v, *, window: int = 0, scale: float | None = None,
              use_kernel: bool = False):
    """The reference's ``attention(use_pallas=)``: the flash kernel with
    ``use_kernel``, else the sequence-parallel path where it applies,
    else chunked above CHUNK_THRESHOLD, else naive."""
    if use_kernel:
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, window=window, scale=scale)
    if _sp_attention_applicable(q, k):
        return sp_attention(q, k, v, window=window, scale=scale)
    if q.shape[1] > CHUNK_THRESHOLD:
        return chunked_attention(q, k, v, window=window, scale=scale)
    return naive_attention(q, k, v, window=window, scale=scale)


def _valid_slots(slot, pos: int, C: int, window: int):
    """Which cache slots hold a token at insert position ``pos``: a ring
    buffer of capacity C when windowed (all slots once it wrapped)."""
    if window > 0 and pos >= C:
        return torch.ones_like(slot, dtype=torch.bool)
    if window > 0:
        return slot <= min(pos, C - 1)
    return slot <= pos


def sp_decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0,
                        scale: float | None = None):
    """Flash-decoding over a sequence-sharded KV cache (shard_map).

    When kv-heads don't divide the model axis the cache shards on its
    SEQUENCE dim. Each rank computes attention against its local cache
    slice and the shards merge with the online-softmax combine (pmax/psum
    of exp-weighted partials): collective traffic is O(B*H*hd), not
    O(C)."""
    spmd.count("sp_decode_attention")
    mesh = shd._current_mesh()
    batch_axes, _, ep = _mesh_dims(mesh)
    B, C, Kv, hd = k_cache.shape
    H = q.shape[2]
    sc = scale if scale is not None else hd ** -0.5
    C_l = C // ep

    def body(q_l, k_l, v_l):
        k = _repeat_kv(k_l, H // Kv)
        v = _repeat_kv(v_l, H // Kv)
        s = torch.einsum("...qhd,...khd->...hqk", q_l, k).to(torch.float32) * sc
        # (*mesh, 1 [batch], 1 [heads], 1 [query], C_l)
        slot = _rank_offsets(4, C_l) + torch.arange(C_l, device=q_l.device)
        s = torch.where(_valid_slots(slot, pos, C, window), s,
                        torch.full((), NEG_INF, dtype=torch.float32, device=s.device))
        m_l = s.amax(dim=-1)                                      # (...,B,H,1)
        p = torch.exp(s - m_l[..., None])
        d_l = p.sum(dim=-1)
        acc_l = torch.einsum("...hqk,...khd->...hqd", p.to(q_l.dtype), v
                             ).to(torch.float32)
        # online-softmax merge across shards
        m = spmd.pmax(m_l, shd.MODEL_AXIS)
        w = torch.exp(m_l - m)
        d = spmd.psum(d_l * w, shd.MODEL_AXIS)
        acc = spmd.psum(acc_l * w[..., None], shd.MODEL_AXIS)
        out = acc / torch.clamp(d[..., None], min=1e-30)
        # (..., B, H, 1, hd) -> (..., B, 1, H, hd)
        return out.transpose(-3, -2).to(q_l.dtype)

    bspec = batch_axes if batch_axes else None
    q_spec = spmd.P(bspec, None, None, None)
    kv_spec = spmd.P(bspec, shd.MODEL_AXIS, None, None)
    return spmd.shard_map(body, mesh, (q_spec, kv_spec, kv_spec), q_spec)(
        q, k_cache, v_cache)


def _sp_decode_applicable(q, k_cache) -> bool:
    from repro_torch.launch.knobs import active

    if not active().sp_attention:
        return False
    mesh = shd._current_mesh()
    if mesh is None or shd.MODEL_AXIS not in mesh.axis_names:
        return False
    _, dp, ep = _mesh_dims(mesh)
    B, C, Kv, _ = k_cache.shape
    # the policy shards the cache seq dim only when kv heads don't divide
    return Kv % ep != 0 and C % ep == 0 and B % dp == 0


@tracing.spanned("attn.core")
def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0,
                     scale: float | None = None):
    """One-token attention against a cache.

    q: (B, 1, H, hd); k/v_cache: (B, C, Kv, hd); pos: current index
    (number of tokens already in cache, 0-based insert position).
    For sliding windows the cache is a ring buffer of capacity C=window and
    slot validity is derived from pos. Under a mesh whose model axis the
    kv heads do not divide, ``sp_decode_attention`` serves it.
    """
    if _sp_decode_applicable(q, k_cache):
        return sp_decode_attention(q, k_cache, v_cache, pos, window=window,
                                   scale=scale)
    B, C, Kv, hd = k_cache.shape
    H = q.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    k = _repeat_kv(k_cache, H // Kv)
    v = _repeat_kv(v_cache, H // Kv)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    valid = _valid_slots(torch.arange(C, device=q.device), pos, C, window)
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


@tracing.spanned("mlp")
def swiglu(params, x):
    dtype = x.dtype
    g = shd.proj(x, weight(params["w_gate"], dtype))
    u = shd.proj(x, weight(params["w_up"], dtype))
    h = F.silu(g) * u
    return shd.proj(h, weight(params["w_down"], dtype))


# --------------------------------------------------------------- embedding
def embedding_schema(vocab: int, d_model: int) -> dict:
    return {"table": ParamDef((vocab, d_model), ("vocab", "embed"),
                              normal_init(0.02))}


def embed(params, ids, dtype):
    # Gather, then cast: the same values as the reference's cast-then-
    # gather, without casting the whole table. A DTensor table takes
    # F.embedding, whose forward and backward DTensor partitions over a
    # cut vocabulary (torch 2.11 failed on indexing's backward there).
    if hasattr(params["table"], "placements"):
        return F.embedding(ids, params["table"]).to(dtype)
    return params["table"][ids].to(dtype)


def embed_token(params, ids, dtype):
    """``embed`` for one decode step's tokens (B, 1), cut over the batch
    axes and whole over the model axis. On a vocabulary cut over the model
    axis, DTensor's ``F.embedding`` leaves a pending masked sum that a
    later elementwise product cannot resolve (AssertionError in
    ``_reduce_shard_value`` at the first norm, torch 2.13); the prefill's
    residual constraint resolves it right after the gather, and so does
    this one."""
    return shd.batch_sharded(embed(params, ids, dtype))


def unembed(params, x, table=None):
    t = weight(table if table is not None else params["table"], x.dtype)
    return shd.proj(x, t.T)


# -------------------------------------------------------------------- loss
def cross_entropy(logits, labels):
    """The reference models' token loss: fp32 log-softmax, positions whose
    label is negative masked, the mean over the rest. logits (..., V),
    labels (...) of any integer dtype.

    On a DTensor (a mesh on a process group, the vocab sharded over
    'model') the log-softmax is written out as max, log-sum-exp and a
    one-hot pick, each a reduction over the vocab that DTensor ends with
    an all-reduce of (B, S) partials, as XLA's partitioner reduces over a
    sharded dim; DTensor's own log-softmax and gather would gather the
    whole (B, S, V) vocab first."""
    if hasattr(logits, "placements"):
        return _cross_entropy_sharded(logits, labels)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _cross_entropy_sharded(logits, labels):
    x = logits.to(torch.float32)
    m = x.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(x - m).sum(dim=-1))
    V = x.shape[-1]
    onehot = torch.clamp(labels, min=0).long()[..., None] == torch.arange(V, device=x.device)
    picked = (x * onehot).sum(dim=-1)
    mask = (labels >= 0).to(torch.float32)
    return ((lse - picked) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
