"""Wrapper of the Hopper matmul kernel (``csrc/matmul.cu``).

Replaces ``repro.kernels.matmul.matmul_pallas``: C = A @ B with fp32
accumulation, output in A's dtype. The kernel is batched: the leading dims
of the operands (the stacked rank dims of an SPMD body) become its batch,
so one launch serves every virtual rank. No shape has to tile evenly: the
fp32 kernel masks its edges, and the bf16 kernel's TMA zero-fills them,
given K and N multiples of 8 (``tma_operands`` pads any other).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch import tracing

DTYPES = {torch.float32: "mapple_matmul_f32",
          torch.bfloat16: "mapple_matmul_bf16"}
_INT_MAX = 2**31 - 1
_GRID_MAX = 65535
TMA_ALIGN = 8          # bf16 elements in 16 bytes: TMA's unit of base and stride


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def tma_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense bf16 operands ``a`` (..., M, K), ``b`` (..., K, N) as the bf16
    kernel's TMA reads them: K and N zero-padded to multiples of 8 (16-byte
    rows; the zeros add nothing to any product, and C's extra columns are
    sliced off), data pointers 16-byte aligned. Each operand that already
    is so comes back as it is; the others are copies. Plain tensor code, so
    it runs on any device."""
    k, n = b.shape[-2:]
    kp, np_ = _round_up(k, TMA_ALIGN), _round_up(n, TMA_ALIGN)
    if kp != k:
        a = F.pad(a, (0, kp - k))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in (a, b))


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors ``a`` (..., M, K), ``b`` (..., K, N).

    Leading dims broadcast; an operand broadcast over them (a replicated
    block) is materialised with ``.contiguous()``, since the kernel reads
    dense row-major batch entries.
    """
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"matmul kernel takes float32 or bfloat16 operands "
                         f"of one dtype, got {a.dtype} and {b.dtype}")
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"matmul kernel needs matrices, got shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    nbatch = 1
    for s in batch:
        nbatch *= s
    if min(m, n, k, nbatch) < 1:
        raise ValueError(f"matmul kernel needs non-empty operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if max(m * k, k * n, m * n) > _INT_MAX or nbatch > _GRID_MAX:
        raise ValueError(f"matmul kernel shape out of range: batch {nbatch}, "
                         f"{m} x {k} x {n}")
    a = a.expand(*batch, m, k).contiguous()
    b = b.expand(*batch, k, n).contiguous()
    n_out = n
    if a.dtype == torch.bfloat16:
        a, b = tma_operands(a, b)
        k, n = b.shape[-2:]
    out = torch.empty((*batch, m, n), dtype=a.dtype, device=a.device)
    lib = build.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(lib.lib, DTYPES[a.dtype])(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), nbatch, m, n, k, stream)
    build.check(lib, err, "matmul")
    tracing.count("kernel.matmul.launches")
    return out if n == n_out else out[..., :n_out]

