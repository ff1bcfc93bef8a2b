"""Wrappers of the Hopper selective-scan kernel (``csrc/mamba_scan.cu``).

Replaces ``repro.kernels.mamba_scan.mamba_scan_pallas``: the Mamba-1
selective scan from a zero state, ``h = exp(dt*A)*h + (dt*x)*B``,
``y = sum_n h*C``; xs/dt (B,T,di), Bs/Cs (B,T,n), A (di,n), n in 4, 8, 16,
32. Returns y (B,T,di) and the final state (B,di,n), fp32. Two
instantiations of the one kernel template:

  * ``mamba_scan_cuda``: the plain scan, all fp32;
  * ``mamba_scan_gated_cuda``: Hymba's mixer from its projections to
    ``w_out``, its tensors as the mixer has them: dt raw (the kernel adds
    dt_bias and takes the softplus), xs, Bs, Cs and z read in place in the
    model dtype (``bc``'s halves, ``xz``'s second half), and
    ``(y + xs*D) * silu(z)`` written once in that dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch import tracing

STATE_SIZES = (4, 8, 16, 32)
_GRID_Y_MAX = 65535            # one grid row per batch element
DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # the C entry points' dtype codes


def row_stride(name: str, x: torch.Tensor, shape: tuple, what: str) -> int:
    """The row stride of a (B, T, C) view that a kernel reads in place: its
    channels adjacent and its rows evenly spaced across the batch (a
    contiguous tensor, or a slice of the last dim of one). Raises for any
    other shape or layout."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    B, T, C = shape
    sb, st, sc = x.stride()
    st = sb if T == 1 else st
    if (C > 1 and sc != 1) or (B > 1 and sb != T * st):
        raise ValueError(f"{what}: {name} of strides {x.stride()} is not read in "
                         f"place: its channels must be adjacent and its rows evenly "
                         f"spaced across the batch")
    return st


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


def mamba_scan_gated_cuda(xs: torch.Tensor, dt: torch.Tensor, Bs: torch.Tensor,
                          Cs: torch.Tensor, A: torch.Tensor, dt_bias: torch.Tensor,
                          D: torch.Tensor, z: torch.Tensor):
    """Launch the gated scan: ``y = (scan(xs, softplus(dt + dt_bias), Bs,
    Cs, A) + xs*D) * silu(z)``. xs, dt (the raw dt projection), Bs, Cs, z
    (B,T,.) and D (di,) in the model dtype, float32 or bfloat16, A (di,n)
    and dt_bias (di,) float32, all on CUDA; xs, dt, Bs, Cs and z are read
    in place (``row_stride``), A, dt_bias and D must be contiguous. Returns
    (y (B,T,di) in the model dtype, state (B,di,n) float32)."""
    named = (("xs", xs), ("dt", dt), ("Bs", Bs), ("Cs", Cs), ("A", A),
             ("dt_bias", dt_bias), ("D", D), ("z", z))
    for name, x in named:
        if x.device.type != "cuda":
            raise ValueError(f"mamba_scan kernel needs CUDA tensors, got {name} "
                             f"on {x.device}")
    if xs.dtype not in DTYPES:
        raise ValueError(f"mamba_scan gated kernel takes float32 or bfloat16, got "
                         f"xs {xs.dtype}")
    for name, x in named:
        want = torch.float32 if name in ("A", "dt_bias") else xs.dtype
        if x.dtype != want:
            raise ValueError(f"mamba_scan gated kernel: {name} is {x.dtype}, expected "
                             f"{want}")
    if xs.ndim != 3 or A.ndim != 2:
        raise ValueError(f"mamba_scan kernel takes xs (B,T,di) and A (di,n), got "
                         f"{tuple(xs.shape)} and {tuple(A.shape)}")
    B, T, di = xs.shape
    n = A.shape[1]
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan kernel: state size {n} not in {STATE_SIZES}")
    if B < 1 or T < 1 or di < 1 or B > _GRID_Y_MAX:
        raise ValueError(f"mamba_scan kernel shape out of range: {tuple(xs.shape)}")
    what = "mamba_scan gated kernel"
    strides = [row_stride(name, x, (B, T, c), what)
               for name, x, c in (("xs", xs, di), ("dt", dt, di), ("Bs", Bs, n),
                                  ("Cs", Cs, n), ("z", z, di))]
    for name, x, shape in (("A", A, (di, n)), ("dt_bias", dt_bias, (di,)), ("D", D, (di,))):
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous of shape {shape}, got "
                             f"{tuple(x.shape)} of strides {x.stride()}")
    y = torch.empty((B, T, di), dtype=xs.dtype, device=xs.device)
    state = torch.empty((B, di, n), dtype=torch.float32, device=xs.device)
    row_strides = (ctypes.c_int64 * 5)(*strides)
    lib = build.load()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = lib.lib.mapple_mamba_scan_gated(
        xs.data_ptr(), dt.data_ptr(), Bs.data_ptr(), Cs.data_ptr(), A.data_ptr(),
        dt_bias.data_ptr(), D.data_ptr(), z.data_ptr(), y.data_ptr(), state.data_ptr(),
        ctypes.addressof(row_strides), B, T, di, n, DTYPES[xs.dtype], stream)
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
