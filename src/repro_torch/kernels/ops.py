"""Public kernel entry points: the hand-written kernel or its plain version.

Replaces the JAX package's ``_interpret()`` switch with a dispatch on the
tensors' device:

  * CPU tensors run the plain PyTorch version (``kernels/ref.py``);
  * anything else goes to the CUDA kernel's wrapper, which launches on a
    CUDA tensor or raises. There is no fallback from the card.

No kernel has a backward (no Pallas kernel of the reference has a VJP
either), so a kernel's output is not tracked by autograd: the CUDA
branches of the LM kernels (flash attention, the selective scan, WKV6)
raise a ``RuntimeError`` when autograd records and an input requires
grad, rather than hand back a loss gradient that skips the kernel.
Training runs the plain path, as the reference does.

Each kernel keeps one integer launch counter (``launch_counts``), raised
only where its wrapper launches it, so a run can show that its path went
through the kernels; the counters are ``kernel.<name>.launches`` of the
port's tracing (``repro_torch/tracing.py``). Each call of an LM kernel entry
point is a ``kernel.<name>`` span there, whichever version runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import mamba_scan as ms_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import stencil as st_mod
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch import tracing

KERNELS = ("matmul", "stencil", "segment_rowmax", "flash_attention", "mamba_scan", "wkv6")


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
