"""Wrapper of the Hopper segment-reduce kernel (``csrc/segment_reduce.cu``).

Replaces ``repro.kernels.segment_reduce.segment_rowmax_pallas``: for a
(rows, cols) table of non-negative congestion loads, ``out[r] = max_j
sum_{i<seg} vals[r, j*seg + i]`` (``seg == 1`` is a plain row max). The
simulator's torch pricing engine (``repro_torch.sim.torch_backend``)
reduces its dense per-level tables with it. float64 (the pricer's
default) and float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

ENTRY = {torch.float32: "mapple_segment_rowmax_f32",
         torch.float64: "mapple_segment_rowmax_f64"}
_ROWS_MAX = 2**31 - 1          # one block per row: the grid's x limit


def segment_rowmax_cuda(vals: torch.Tensor, seg: int = 1) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor ``vals`` (rows, cols), vals >= 0."""
    if vals.device.type != "cuda":
        raise ValueError(f"segment_rowmax kernel needs a CUDA tensor, got "
                         f"{vals.device}")
    if vals.dtype not in ENTRY:
        raise ValueError(f"segment_rowmax kernel takes float32 or float64, "
                         f"got {vals.dtype}")
    if vals.ndim != 2:
        raise ValueError(f"segment_rowmax kernel needs a 2D table, got shape "
                         f"{tuple(vals.shape)}")
    rows, cols = vals.shape
    seg = int(seg)
    if seg < 1 or cols % seg:
        raise ValueError(f"segment length {seg} does not divide {cols} "
                         f"columns")
    if rows < 1 or cols < 1 or rows > _ROWS_MAX:
        raise ValueError(f"segment_rowmax kernel shape out of range: "
                         f"{tuple(vals.shape)}")
    vals = vals.contiguous()
    out = torch.empty((rows,), dtype=vals.dtype, device=vals.device)
    lib = build.load()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = getattr(lib.lib, ENTRY[vals.dtype])(
        vals.data_ptr(), out.data_ptr(), rows, cols, seg, stream)
    build.check(lib, err, "segment_rowmax")
    segment_rowmax_cuda.launches += 1
    return out


segment_rowmax_cuda.launches = 0
