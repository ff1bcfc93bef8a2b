"""Wrapper of the Hopper matmul kernel (``csrc/matmul.cu``).

Replaces ``repro.kernels.matmul.matmul_pallas``: C = A @ B with fp32
accumulation, output in A's dtype. The kernel is batched: the leading dims
of the operands (the stacked rank dims of an SPMD body) become its batch,
so one launch serves every virtual rank. Edges are masked, so no shape has
to tile evenly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: "mapple_matmul_f32",
          torch.bfloat16: "mapple_matmul_bf16"}
_INT_MAX = 2**31 - 1
_GRID_MAX = 65535


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
    out = torch.empty((*batch, m, n), dtype=a.dtype, device=a.device)
    lib = build.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(lib.lib, DTYPES[a.dtype])(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), nbatch, m, n, k, stream)
    build.check(lib, err, "matmul")
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0
