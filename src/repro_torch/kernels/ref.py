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
