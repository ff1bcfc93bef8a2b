"""Wrapper of the Hopper flash-attention kernels: ``csrc/flash_attention.cu``
(fp32, CUDA cores) and ``csrc/flash_attention_bf16.cu`` (bf16, tensor cores).

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``: causal
(optionally sliding-window) softmax attention with an fp32 online
softmax, masked scores at -1e30 and the denominator clamped at 1e-30.
Unlike the Pallas kernel it takes the model layout, q (B,S,H,d) and k/v
(B,S,Kv,d), reading KV head ``h // (H/Kv)`` for query head ``h`` (no GQA
repeat, no transpose), and any S. fp32 and bf16; d a multiple of 16 up
to 128.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch import tracing

ENTRY = {torch.float32: "mapple_flash_attention_f32",
         torch.bfloat16: "mapple_flash_attention_bf16"}
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
_GRID_Y_MAX = 65535            # one grid row per query tile
_MIN_BQ = 64                   # the smallest query tile of either kernel


def kernel_ready(x: torch.Tensor) -> bool:
    """Whether the kernels can read ``x`` in place: their 16-byte
    ``cp.async`` copies (and the bf16 kernel's ``ldmatrix`` rows) need the
    last dim contiguous, the data pointer 16-byte aligned and the batch,
    seq and head strides multiples of 16 bytes (8 bf16, 4 fp32 elements)."""
    per_16 = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % per_16 == 0 for s in x.stride()[:-1]))


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if the kernels can read it in place, else a fresh
    contiguous copy (a copy, not another route: ``.contiguous()`` would
    hand back a contiguous view whose data pointer is misaligned)."""
    return x if kernel_ready(x) else x.clone(memory_format=torch.contiguous_format)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float | None = None, window: int = 0,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel: q (B,S,H,d), k/v (B,S,Kv,d) CUDA tensors of one
    dtype -> (B,S,H,d) in q's dtype."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                             f"{name} on {x.device}")
        if x.ndim != 4:
            raise ValueError(f"flash_attention kernel takes (B,S,heads,d), got "
                             f"{name} of shape {tuple(x.shape)}")
    if q.dtype not in ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, S, H, d = q.shape
    Kv = k.shape[2]
    if k.shape != (B, S, Kv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if Kv < 1 or H % Kv:
        raise ValueError(f"flash_attention kernel: {H} query heads are not a "
                         f"multiple of {Kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in {HEAD_DIMS}")
    if S < 1 or -(-S // _MIN_BQ) > _GRID_Y_MAX:
        raise ValueError(f"flash_attention kernel shape out of range: "
                         f"{tuple(q.shape)}")
    q, k, v = (kernel_operand(x) for x in (q, k, v))
    scale = float(scale) if scale is not None else d ** -0.5
    out = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out)
                                      for s in x.stride()[:3]))
    lib = build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib.lib, ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), B, S, H, Kv, d, scale, int(window),
        int(bool(causal)), stream)
    build.check(lib, err, "flash_attention")
    tracing.count("kernel.flash_attention.launches")
    return out

