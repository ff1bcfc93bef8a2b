"""Wrapper of the Hopper selective-scan kernel (``csrc/mamba_scan.cu``).

Replaces ``repro.kernels.mamba_scan.mamba_scan_pallas``: the Mamba-1
selective scan from a zero state, ``h = exp(dt*A)*h + (dt*x)*B``,
``y = sum_n h*C``; xs/dt (B,T,di), Bs/Cs (B,T,n), A (di,n), all fp32 (as
Hymba's mixer hands them over), n in 4, 8, 16, 32. Returns y (B,T,di) and
the final state (B,di,n).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch import tracing

STATE_SIZES = (4, 8, 16, 32)
_GRID_Y_MAX = 65535            # one grid row per batch element


def mamba_scan_cuda(xs: torch.Tensor, dt: torch.Tensor, Bs: torch.Tensor,
                    Cs: torch.Tensor, A: torch.Tensor):
    """Launch the kernel on CUDA fp32 tensors; returns (y, state)."""
    named = (("xs", xs), ("dt", dt), ("Bs", Bs), ("Cs", Cs), ("A", A))
    for name, x in named:
        if x.device.type != "cuda":
            raise ValueError(f"mamba_scan kernel needs CUDA tensors, got {name} "
                             f"on {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"mamba_scan kernel takes float32, got {name} "
                             f"{x.dtype}")
    if xs.ndim != 3 or A.ndim != 2:
        raise ValueError(f"mamba_scan kernel takes xs (B,T,di) and A (di,n), got "
                         f"{tuple(xs.shape)} and {tuple(A.shape)}")
    B, T, di = xs.shape
    n = A.shape[1]
    if (dt.shape != xs.shape or Bs.shape != (B, T, n) or Cs.shape != (B, T, n)
            or A.shape != (di, n)):
        raise ValueError(f"mamba_scan kernel: shapes do not fit xs "
                         f"{tuple(xs.shape)}: dt {tuple(dt.shape)}, Bs "
                         f"{tuple(Bs.shape)}, Cs {tuple(Cs.shape)}, A {tuple(A.shape)}")
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan kernel: state size {n} not in {STATE_SIZES}")
    if B < 1 or T < 1 or di < 1 or B > _GRID_Y_MAX:
        raise ValueError(f"mamba_scan kernel shape out of range: {tuple(xs.shape)}")
    xs, dt, Bs, Cs, A = (x.contiguous() for _, x in named)
    y = torch.empty_like(xs)
    state = torch.empty((B, di, n), dtype=torch.float32, device=xs.device)
    lib = build.load()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = lib.lib.mapple_mamba_scan_f32(
        xs.data_ptr(), dt.data_ptr(), Bs.data_ptr(), Cs.data_ptr(), A.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, T, di, n, stream)
    build.check(lib, err, "mamba_scan")
    tracing.count("kernel.mamba_scan.launches")
    return y, state



def occupancy(n: int) -> tuple[int, int]:
    """Registers per thread and resident warps per SM of the kernel that a
    launch at state size ``n`` runs, as the CUDA runtime reports them."""
    regs, warps = ctypes.c_int(), ctypes.c_int()
    lib = build.load()
    err = lib.lib.mapple_mamba_scan_occupancy(n, ctypes.byref(regs), ctypes.byref(warps))
    build.check(lib, err, "mamba_scan occupancy query")
    return regs.value, warps.value
