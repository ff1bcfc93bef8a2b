"""Plain PyTorch versions of the hand-written kernels.

The CPU path of ``repro_torch.kernels.ops`` runs these, and the card's
parity checks hold each kernel against them on the same inputs. They
follow ``repro.kernels.ref`` (the JAX package's oracles) operation for
operation.
"""
from __future__ import annotations

import torch


def no_tf32() -> None:
    """Keep fp32 products in full fp32 on the card (TF32 keeps about three
    decimal digits and breaks the 1e-4 fp32 tolerance)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with fp32 accumulation, output in A's dtype; batched over
    the leading dims (broadcast as ``torch.matmul`` does)."""
    no_tf32()
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


def edge_pad(field: torch.Tensor) -> torch.Tensor:
    """1-deep edge-replicate padding of the last two dims (``mode="edge"``)."""
    f = torch.cat([field[..., :1, :], field, field[..., -1:, :]], dim=-2)
    return torch.cat([f[..., :1], f, f[..., -1:]], dim=-1)


def stencil_interior(padded: torch.Tensor) -> torch.Tensor:
    """One 5-point Jacobi sweep over the interior of a halo-padded block:
    (..., H+2, W+2) -> (..., H, W)."""
    c = padded[..., 1:-1, 1:-1]
    n = padded[..., :-2, 1:-1]
    s = padded[..., 2:, 1:-1]
    w = padded[..., 1:-1, :-2]
    e = padded[..., 1:-1, 2:]
    return (0.2 * (c + n + s + w + e)).to(padded.dtype)


def stencil(field: torch.Tensor) -> torch.Tensor:
    """One 5-point Jacobi sweep, edge-replicate boundaries, batched over the
    leading dims."""
    return stencil_interior(edge_pad(field))


def segment_rowmax(vals: torch.Tensor, seg: int = 1) -> torch.Tensor:
    """Per-row max of contiguous length-``seg`` segment sums (vals >= 0)."""
    rows, cols = vals.shape
    return vals.reshape(rows, cols // seg, seg).sum(2).amax(1)


NEG_INF = -1e30


def flash_attention(q, k, v, *, scale=None, window: int = 0, causal: bool = True):
    """q/k/v: (BH, S, d) — naive softmax attention (KV already repeated
    for GQA), masked scores at -1e30."""
    BH, S, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) * scale
    pos = torch.arange(S, device=q.device)
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (pos[:, None] >= pos[None, :])
    if window > 0:
        ok = ok & (pos[:, None] - pos[None, :] < window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def wkv6(r, k, v, w, u):
    """Sequential-scan WKV6 from a zero state. r/k/v/w: (BH,T,N); u: (BH,N).
    Returns (y (BH,T,N) in r's dtype, final state (BH,N,N) fp32), with the
    Pallas kernel's order of operations at each step."""
    BH, T, N = r.shape
    s = torch.zeros((BH, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(T):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[:, :, None] * v_t[:, None, :]
        ys.append(((s + u[:, :, None] * kv) * r_t[:, :, None]).sum(dim=1))
        s = w_t[:, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def mamba_scan(xs, dt, Bs, Cs, A):
    """Sequential selective scan from a zero state. xs/dt: (B,T,di);
    Bs/Cs: (B,T,n); A: (di,n). Returns (y (B,T,di) in xs's dtype, final
    state (B,di,n) fp32)."""
    B, T, di = xs.shape
    n = A.shape[1]
    h = torch.zeros((B, di, n), dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(T):
        x_t, dt_t, B_t, C_t = xs[:, t], dt[:, t], Bs[:, t], Cs[:, t]
        dA = torch.exp(dt_t[:, :, None] * A)
        h = dA * h + (dt_t * x_t)[:, :, None] * B_t[:, None, :]
        ys.append((h * C_t[:, None, :]).sum(dim=2))
    return torch.stack(ys, dim=1).to(xs.dtype), h
