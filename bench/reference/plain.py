"""Pieces the plain references share: float32 products (TF32 off) or the
control's fp8 ones, norms, rotary embeddings, and the two scans in a
chunked form whose Python loops run over chunks, not tokens.

Nothing here imports the program: every reference reads the parameter
tree by key and the configuration as a plain dict.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
F64 = torch.float64
FP8_MAX = 448.0           # largest finite float8_e4m3fn
SCAN_CHUNK = 16           # tokens a chunk; float64 keeps exp(-cumsum) finite
BLOCK_ELEMS = 100_000_000  # float64 elements a scan block may hold (800 MB)


def no_tf32() -> None:
    """Full float32 products: a float32 matmul on the card may run in
    TF32, which keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest |entry| to 448), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(F32) * s


class Precision:
    """How the reference's weight products are computed: ``fp32``, or
    ``fp8``, the control: both operands of every product with a weight
    (the projections and the head) rounded to e4m3 first."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.to(F32), w.to(F32)
        if self.name == "fp8":
            x, w = fp8(x), fp8(w)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on halves (x1, x2) of the head dim: x (B,T,h,d),
    pos (T,) integer positions."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32, device=x.device) / d))
    ang = pos.to(F32)[:, None] * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def window_attention(q, k, v, q_pos, k_pos, window: int, q_block: int = 1024):
    """Causal softmax attention within ``window`` (0: no window), by
    blocks of queries: q (B,Tq,H,d), k/v (B,Tk,Kv,d), query head h reads
    key head h // (H/Kv); ``q_pos`` and ``k_pos`` ascending positions."""
    B, Tq, H, d = q.shape
    groups = H // k.shape[2]
    out = torch.empty_like(q, dtype=F32)
    for a in range(0, Tq, q_block):
        qp = q_pos[a:a + q_block]
        lo = 0 if window <= 0 else int((k_pos < qp[0] - window + 1).sum())
        hi = int((k_pos <= qp[-1]).sum())
        kp = k_pos[lo:hi]
        kb = k[:, lo:hi].to(F32).repeat_interleave(groups, dim=2)
        vb = v[:, lo:hi].to(F32).repeat_interleave(groups, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, a:a + q_block].to(F32), kb) * d ** -0.5
        ok = qp[:, None] >= kp[None, :]
        if window > 0:
            ok &= (qp[:, None] - kp[None, :]) < window
        s = s.masked_fill(~ok, float("-inf"))
        out[:, a:a + q_block] = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vb)
    return out


def _chunks(T: int, per_token: int) -> tuple[int, int]:
    """Padded length and tokens a block: a multiple of SCAN_CHUNK."""
    Tp = -(-T // SCAN_CHUNK) * SCAN_CHUNK
    tb = max(SCAN_CHUNK, BLOCK_ELEMS // max(per_token, 1) // SCAN_CHUNK * SCAN_CHUNK)
    return Tp, min(tb, Tp)


def _pad_time(t: torch.Tensor, Tp: int, value: float = 0.0) -> torch.Tensor:
    return F.pad(t, (0,) * (2 * (t.ndim - 2)) + (0, Tp - t.shape[1]), value=value)


def selective_scan(xs, dt, Bm, Cm, A, h0):
    """The Mamba-1 scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
    y_t = h_t . C_t, chunk by chunk in float64: inside a chunk from the
    cumulative log decay, across chunks by carrying the state.
    xs/dt (B,T,di), Bm/Cm (B,T,n), A (di,n), h0 (B,di,n) ->
    (y (B,T,di) float32, final state float32)."""
    Bsz, T, di = xs.shape
    n = A.shape[1]
    L = SCAN_CHUNK
    Tp, tb = _chunks(T, Bsz * di * n)
    xs, dt, Bm, Cm = (_pad_time(t.to(F64), Tp) for t in (xs, dt, Bm, Cm))
    A = A.to(F64)
    h = h0.to(F64)
    ys = []
    for a in range(0, Tp, tb):
        nc = min(tb, Tp - a) // L

        def blk(t):
            return t[:, a:a + nc * L].reshape(Bsz, nc, L, t.shape[-1])

        x_, dt_, B_, C_ = blk(xs), blk(dt), blk(Bm), blk(Cm)
        LA = dt_.cumsum(2)[..., None] * A                      # (B,nc,L,di,n) <= 0
        u = (dt_ * x_)[..., None] * B_[:, :, :, None, :]
        hl = LA.exp() * (torch.exp(-LA) * u).cumsum(2)         # from a zero start
        if not torch.isfinite(hl).all():
            raise FloatingPointError("selective_scan: a chunk's decay left float64's range")
        starts = []
        for c in range(nc):
            starts.append(h)
            h = LA[:, c, -1].exp() * h + hl[:, c, -1]
        hfull = hl + LA.exp() * torch.stack(starts, 1)[:, :, None]
        ys.append(torch.einsum("bcldn,bcln->bcld", hfull, C_).reshape(Bsz, nc * L, di))
    return torch.cat(ys, 1)[:, :T].to(F32), h.to(F32)


def wkv6(r, k, v, w, u, S0):
    """The RWKV-6 recurrence y_t = r_t . (S + diag(u) k_t v_t^T),
    S <- diag(w_t) S + k_t v_t^T, chunk by chunk in float64.
    r/k/v/w (B,T,H,N), u (H,N), S0 (B,H,N,N) -> (y (B,T,H,N) float32,
    final state float32)."""
    Bsz, T, H, N = r.shape
    L = SCAN_CHUNK
    Tp, tb = _chunks(T, Bsz * H * N * N // L)

    def prep(t, value=0.0):
        # (B,T,H,N) -> (B,H,Tp,N), float64, padded (w with 1: no decay)
        return _pad_time(t.to(F64), Tp, value).transpose(1, 2)

    r, k, v = prep(r), prep(k), prep(v)
    lw = prep(w, 1.0).log()
    uu = u.to(F64)[None, :, None, None, :]
    S = S0.to(F64)
    mask = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for a in range(0, Tp, tb):
        nc = min(tb, Tp - a) // L

        def blk(t):
            return t[:, :, a:a + nc * L].reshape(Bsz, H, nc, L, N)

        r_, k_, v_, lw_ = blk(r), blk(k), blk(v), blk(lw)
        LA = lw_.cumsum(3)                                      # inclusive, <= 0
        rd = r_ * (LA - lw_).exp()                              # r_t A_{t-1}
        ki = k_ * torch.exp(-LA)                                # k_s / A_s
        if not torch.isfinite(ki).all():
            raise FloatingPointError("wkv6: a chunk's decay left float64's range")
        sc = torch.einsum("bhcti,bhcsi->bhcts", rd, ki).masked_fill(~mask, 0.0)
        y = torch.einsum("bhcts,bhcsj->bhctj", sc, v_)
        y = y + (r_ * uu * k_).sum(-1, keepdim=True) * v_
        kd = k_ * (LA[..., -1:, :] - LA).exp()
        D = torch.einsum("bhcsi,bhcsj->bhcij", kd, v_)
        decay = LA[..., -1, :].exp()                            # (B,H,nc,N)
        starts = []
        for c in range(nc):
            starts.append(S)
            S = decay[:, :, c, :, None] * S + D[:, :, c]
        y = y + torch.einsum("bhcti,bhcij->bhctj", rd, torch.stack(starts, 2))
        ys.append(y.reshape(Bsz, H, nc * L, N))
    y = torch.cat(ys, 2)[:, :, :T].transpose(1, 2)
    return y.to(F32), S.to(F32)
