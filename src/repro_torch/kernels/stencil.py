"""Wrapper of the Hopper 5-point stencil kernel (``csrc/stencil.cu``).

Replaces ``repro.kernels.stencil.stencil_pallas``: one Jacobi sweep
``0.2 * (c + n + s + w + e)`` in fp32, batched over the leading dims. One
kernel serves both call sites:

  * ``interior=False``: output shape == input shape, edge-replicate
    boundaries (exactly ``stencil_pallas``);
  * ``interior=True``: the input is a halo-padded block (..., H+2, W+2) and
    the output its (..., H, W) interior: the stencil app's per-rank sweep
    after its halo exchange, every rank in one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch import tracing

_INT_MAX = 2**31 - 1
_GRID_MAX = 65535


def stencil_cuda(x: torch.Tensor, *, interior: bool) -> torch.Tensor:
    """Launch the kernel on a float32 CUDA tensor ``x`` (..., H, W)."""
    if x.device.type != "cuda":
        raise ValueError(f"stencil kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"stencil kernel takes float32, got {x.dtype}")
    if x.ndim < 2:
        raise ValueError(f"stencil kernel needs a 2D field, got shape "
                         f"{tuple(x.shape)}")
    h, w = x.shape[-2:]
    offset = 1 if interior else 0
    h_out, w_out = h - 2 * offset, w - 2 * offset
    lead = x.shape[:-2]
    nbatch = 1
    for s in lead:
        nbatch *= s
    if min(h_out, w_out, nbatch) < 1:
        raise ValueError(f"stencil kernel needs a non-empty "
                         f"{'padded block' if interior else 'field'}, got "
                         f"shape {tuple(x.shape)}")
    if h * w > _INT_MAX or nbatch > _GRID_MAX:
        raise ValueError(f"stencil kernel shape out of range: "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty((*lead, h_out, w_out), dtype=x.dtype, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lib.mapple_stencil_f32(x.data_ptr(), out.data_ptr(), nbatch,
                                     h, w, h_out, w_out, offset, stream)
    build.check(lib, err, "stencil")
    tracing.count("kernel.stencil.launches")
    return out

