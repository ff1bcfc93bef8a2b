"""Public kernel entry points: the hand-written kernel or its plain version.

Replaces the JAX package's ``_interpret()`` switch with a dispatch on the
tensors' device:

  * CPU tensors run the plain PyTorch version (``kernels/ref.py``);
  * anything else goes to the CUDA kernel's wrapper, which launches on a
    CUDA tensor or raises. There is no fallback from the card.

Each kernel keeps one integer launch counter (``launch_counts``), raised
only where its wrapper launches it, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import stencil as st_mod


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


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


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {"matmul": mm_mod.matmul_cuda.launches,
            "stencil": st_mod.stencil_cuda.launches,
            "segment_rowmax": sr_mod.segment_rowmax_cuda.launches}


def reset_launch_counts() -> None:
    mm_mod.matmul_cuda.launches = 0
    st_mod.stencil_cuda.launches = 0
    sr_mod.segment_rowmax_cuda.launches = 0
