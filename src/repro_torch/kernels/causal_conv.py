"""Wrapper of the Hopper causal-conv + SiLU kernel (``csrc/causal_conv.cu``).

The input stage of Hymba's Mamba mixer on the prefill: the depthwise
causal conv1d of ``models/hymba.py``'s ``_causal_conv`` and the SiLU after
it, in one pass. x (B,T,di) is read in place (rows at any stride: the xs
half of the in-projection's xz), with the (W,di) conv weight and an
optional (B,W-1,di) tail of earlier inputs (zeros without one), all in one
dtype, float32 or bfloat16, W = 4 (Mamba's d_conv; the plain version in
``ops`` takes any W). Returns ``y = silu(conv(x))``
(B,T,di), contiguous, and the new tail (B,W-1,di): the conv's last W-1
inputs. The sum and the SiLU run in fp32, rounded once. No Pallas kernel
of the reference does this (it is XLA's there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import DTYPES, row_stride
from repro_torch import tracing

WIDTH = 4                      # csrc/causal_conv.cu's W
_GRID_Y_MAX = 65535            # one grid row per batch element


def causal_conv_silu_cuda(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None = None):
    """Launch the kernel on CUDA tensors; returns (y, new tail)."""
    named = (("x", x), ("w", w)) + (() if tail is None else (("tail", tail),))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"causal_conv kernel needs CUDA tensors, got {name} on "
                             f"{t.device}")
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise ValueError(f"causal_conv kernel takes float32 or bfloat16, all of "
                             f"one dtype, got {name} {t.dtype} beside x {x.dtype}")
    if x.ndim != 3 or w.ndim != 2:
        raise ValueError(f"causal_conv kernel takes x (B,T,di) and w (W,di), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, T, di = x.shape
    W = w.shape[0]
    if W != WIDTH or w.shape[1] != di:
        raise ValueError(f"causal_conv kernel: w {tuple(w.shape)} must be ({WIDTH}, {di}): "
                         f"the kernel's width is {WIDTH}")
    if B < 1 or T < 1 or di < 1 or B > _GRID_Y_MAX:
        raise ValueError(f"causal_conv kernel shape out of range: {tuple(x.shape)}")
    sx = row_stride("x", x, (B, T, di), "causal_conv kernel")
    for name, t, shape in (("w", w, (W, di)), ("tail", tail, (B, W - 1, di))):
        if t is not None and (tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"causal_conv kernel: {name} must be contiguous of shape "
                             f"{shape}, got {tuple(t.shape)} of strides {t.stride()}")
    y = torch.empty((B, T, di), dtype=x.dtype, device=x.device)
    tail_out = torch.empty((B, W - 1, di), dtype=x.dtype, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lib.mapple_causal_conv_silu(
        x.data_ptr(), w.data_ptr(), None if tail is None else tail.data_ptr(), y.data_ptr(),
        tail_out.data_ptr(), sx, B, T, di, W, DTYPES[x.dtype], stream)
    build.check(lib, err, "causal_conv")
    tracing.count("kernel.causal_conv.launches")
    return y, tail_out
