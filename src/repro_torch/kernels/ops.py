"""Public kernel entry points: the hand-written kernel or its plain version.

Replaces the JAX package's ``_interpret()`` switch with a dispatch on the
tensors' device:

  * CPU tensors run the plain PyTorch version (``kernels/ref.py``);
  * anything else goes to the CUDA kernel's wrapper, which launches on a
    CUDA tensor or raises. There is no fallback from the card.

No kernel has a backward (no Pallas kernel of the reference has a VJP
either), so a kernel's output is not tracked by autograd: the CUDA
branches of the LM kernels (flash attention, the selective scan, WKV6,
the causal conv) raise a ``RuntimeError`` when autograd records and an
input requires grad, rather than hand back a loss gradient that skips the
kernel.
Training runs the plain path, as the reference does.

Each kernel keeps one integer launch counter (``launch_counts``), raised
only where its wrapper launches it, so a run can show that its path went
through the kernels; the counters are ``kernel.<name>.launches`` of the
port's tracing (``repro_torch/tracing.py``). Each call of an LM kernel entry
point is a ``kernel.<name>`` span there, whichever version runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import causal_conv as cc_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import mamba_scan as ms_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import stencil as st_mod
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch import tracing

KERNELS = ("matmul", "stencil", "segment_rowmax", "flash_attention", "mamba_scan", "wkv6",
           "causal_conv")


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _untracked(name: str, *xs: torch.Tensor) -> None:
    """Raise before a kernel launch whose output autograd would need."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad; train with use_kernel=False (the plain path, as the "
            f"reference trains), or call it under torch.no_grad()")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B, fp32 accumulation, output in A's dtype; batched over the
    leading dims (one launch for all of them)."""
    if _on_cpu(a, b):
        return ref.matmul(a, b)
    return mm_mod.matmul_cuda(a, b)


def stencil_step(field: torch.Tensor) -> torch.Tensor:
    """One 5-point Jacobi sweep with edge-replicate boundaries, batched over
    the leading dims (``repro.kernels.ops.stencil_step``)."""
    if _on_cpu(field):
        return ref.stencil(field)
    return st_mod.stencil_cuda(field, interior=False)


def stencil_interior(padded: torch.Tensor) -> torch.Tensor:
    """One 5-point Jacobi sweep over the interior of halo-padded blocks,
    (..., H+2, W+2) -> (..., H, W)."""
    if _on_cpu(padded):
        return ref.stencil_interior(padded)
    return st_mod.stencil_cuda(padded, interior=True)


def segment_rowmax(vals: torch.Tensor, seg: int = 1) -> torch.Tensor:
    """Per-row max of length-``seg`` segment sums of a (rows, cols) table
    with vals >= 0 (the pricing engine's congestion reduce)."""
    if _on_cpu(vals):
        return ref.segment_rowmax(vals, seg)
    return sr_mod.segment_rowmax_cuda(vals, seg)


def flash_attention_plain(q, k, v, *, window: int = 0, scale=None,
                          causal: bool = True) -> torch.Tensor:
    """The plain version in the model layout, as ``repro.kernels.ops``
    wraps its kernel: GQA by repeating the KV heads, then (B,S,H,hd) ->
    (BH,S,hd) and back around ``ref.flash_attention``."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    if Kv != H:
        k = torch.repeat_interleave(k, H // Kv, dim=2)
        v = torch.repeat_interleave(v, H // Kv, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, S, hd)
    kf = k.transpose(1, 2).reshape(B * H, S, hd)
    vf = v.transpose(1, 2).reshape(B * H, S, hd)
    out = ref.flash_attention(qf, kf, vf, window=window, scale=scale,
                              causal=causal)
    return out.reshape(B, H, S, hd).transpose(1, 2)


@tracing.spanned("kernel.flash_attention")
def flash_attention(q, k, v, *, window: int = 0, scale=None,
                    causal: bool = True) -> torch.Tensor:
    """Model-layout attention: q (B,S,H,hd), k/v (B,S,Kv,hd) -> (B,S,H,hd).
    The kernel reads the layout and the GQA grouping in place."""
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, window=window, scale=scale,
                                     causal=causal)
    _untracked("flash_attention", q, k, v)
    return fa_mod.flash_attention_cuda(q, k, v, window=window, scale=scale,
                                       causal=causal)


@tracing.spanned("kernel.mamba_scan")
def mamba_scan(xs, dt, Bs, Cs, A):
    """Selective scan from a zero state: xs/dt (B,T,di), Bs/Cs (B,T,n),
    A (di,n) -> (y (B,T,di), final state (B,di,n))."""
    if _on_cpu(xs, dt, Bs, Cs, A):
        return ref.mamba_scan(xs, dt, Bs, Cs, A)
    _untracked("mamba_scan", xs, dt, Bs, Cs, A)
    return ms_mod.mamba_scan_cuda(xs, dt, Bs, Cs, A)


def mamba_scan_gated_plain(xs, dt, Bs, Cs, A, dt_bias, D, z):
    """The plain version of the gated scan: ``softplus(dt + dt_bias)``, the
    scan (``ref.mamba_scan``) and ``(y + xs*D) * silu(z)``, all in fp32,
    rounded once to xs's dtype."""
    f32 = torch.float32
    xf = xs.to(f32)
    y, state = ref.mamba_scan(xf, F.softplus(dt.to(f32) + dt_bias.to(f32)), Bs.to(f32),
                              Cs.to(f32), A)
    return ((y + xf * D.to(f32)) * F.silu(z.to(f32))).to(xs.dtype), state


@tracing.spanned("kernel.mamba_scan")
def mamba_scan_gated(xs, dt, Bs, Cs, A, dt_bias, D, z):
    """Hymba's mixer from its projections to ``w_out``, the scan's second
    instantiation: xs, dt (the raw dt projection), z (B,T,di), Bs/Cs
    (B,T,n), D (di,) in the model dtype, A (di,n) and dt_bias (di,) fp32 ->
    (``(y + xs*D) * silu(z)`` (B,T,di) in the model dtype, where y is the
    scan of xs with ``softplus(dt + dt_bias)``; final state (B,di,n)). The
    kernel reads xs, dt, Bs, Cs and z in place (``bc``'s halves, ``xz``'s
    second half)."""
    if _on_cpu(xs, dt, Bs, Cs, A, dt_bias, D, z):
        return mamba_scan_gated_plain(xs, dt, Bs, Cs, A, dt_bias, D, z)
    _untracked("mamba_scan", xs, dt, Bs, Cs, A, dt_bias, D, z)
    return ms_mod.mamba_scan_gated_cuda(xs, dt, Bs, Cs, A, dt_bias, D, z)


def causal_conv_silu_plain(x, w, tail=None):
    """The plain version: ``models/hymba.py``'s causal conv summed in fp32,
    the SiLU, rounded once to x's dtype; the new tail is the conv's last
    W-1 inputs."""
    B, T, di = x.shape
    W = w.shape[0]
    pad = (torch.zeros((B, W - 1, di), dtype=x.dtype, device=x.device) if tail is None
           else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                     # (B, T+W-1, di)
    xf, wf = xp.to(torch.float32), w.to(torch.float32)
    y = xf[:, 0:T] * wf[0]
    for i in range(1, W):
        y = y + xf[:, i:i + T] * wf[i]
    return F.silu(y).to(x.dtype), xp[:, T:]


@tracing.spanned("kernel.causal_conv")
def causal_conv_silu(x, w, tail=None):
    """``silu`` of the depthwise causal conv1d: x (B,T,di), w (W,di), tail
    (B,W-1,di) of earlier inputs or None (zeros) -> (y (B,T,di) in x's
    dtype, new tail (B,W-1,di)). The kernel reads x in place (the xs half
    of ``xz``) and sums in fp32."""
    named = (x, w) if tail is None else (x, w, tail)
    if _on_cpu(*named):
        return causal_conv_silu_plain(x, w, tail)
    _untracked("causal_conv", *named)
    return cc_mod.causal_conv_silu_cuda(x, w, tail)


def wkv6_plain(r, k, v, w, u):
    """The plain version in the model layout, as ``repro.kernels.ops``
    wraps its kernel: (B,S,H,N) -> (BH,S,N), u broadcast over the batch,
    then back around ``ref.wkv6``."""
    B, S, H, N = r.shape

    def to_flat(t):
        return t.transpose(1, 2).reshape(B * H, S, N)

    uf = u[None].expand(B, H, N).reshape(B * H, N)
    y, s = ref.wkv6(to_flat(r), to_flat(k), to_flat(v), to_flat(w), uf)
    return y.reshape(B, H, S, N).transpose(1, 2), s.reshape(B, H, N, N)


@tracing.spanned("kernel.wkv6")
def wkv6(r, k, v, w, u):
    """RWKV-6 WKV from a zero state in the model layout: r/k/v/w (B,S,H,N)
    fp32, u (H,N) -> (y (B,S,H,N), final state (B,H,N,N)). There is no
    state argument: the kernel always starts from zeros (the reference's
    wrapper takes one and drops it); a carried state stays on the model's
    scan. The kernel reads the layout in place."""
    if _on_cpu(r, k, v, w, u):
        return wkv6_plain(r, k, v, w, u)
    _untracked("wkv6", r, k, v, w, u)
    return wkv_mod.wkv6_cuda(r, k, v, w, u)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    counts = tracing.counters()
    return {name: counts.get(f"kernel.{name}.launches", 0) for name in KERNELS}


def reset_launch_counts() -> None:
    tracing.reset(*(f"kernel.{name}.launches" for name in KERNELS))
