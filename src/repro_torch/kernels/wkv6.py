"""Wrapper of the Hopper WKV6 kernel (``csrc/wkv6.cu``).

Replaces ``repro.kernels.wkv6.wkv6_pallas``: the RWKV-6 recurrence
``y_t = r_t . (S + diag(u) k_t v_t^T)``, ``S <- diag(w_t) S + k_t v_t^T``
from a zero state. Unlike the Pallas kernel it takes the model layout,
r/k/v/w (B,T,H,N) and u (H,N), read in place through their strides (no
transposed copies), and any T >= 1. fp32, N in 16, 32, 64. Returns y
(B,T,H,N) and the final state (B,H,N,N), both fp32.

There is no initial-state argument: the kernel always starts from zeros.
Decode, which carries a state, stays on the model's scan.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch import tracing

HEAD_SIZES = (16, 32, 64)
_GRID_MAX = 2 ** 31 - 1        # one grid row per (batch, head)


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """Launch the kernel on CUDA fp32 tensors; returns (y, state)."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u))
    for name, x in named:
        if x.dtype != torch.float32:
            raise ValueError(f"wkv6 kernel takes float32, got {name} {x.dtype}")
    if r.ndim != 4:
        raise ValueError(f"wkv6 kernel takes r/k/v/w (B,T,H,N), got r of shape "
                         f"{tuple(r.shape)}")
    B, T, H, N = r.shape
    if any(x.shape != r.shape for x in (k, v, w)) or u.shape != (H, N):
        raise ValueError(f"wkv6 kernel: shapes do not fit r {tuple(r.shape)}: k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel: head size {N} not in {HEAD_SIZES}")
    if B < 1 or T < 1 or H < 1 or B * H > _GRID_MAX:
        raise ValueError(f"wkv6 kernel shape out of range: {tuple(r.shape)}")
    for name, x in named:
        if x.device.type != "cuda":
            raise ValueError(f"wkv6 kernel needs CUDA tensors, got {name} on "
                             f"{x.device}")
    r, k, v, w = (x if x.stride(-1) == 1 else x.contiguous() for x in (r, k, v, w))
    u = u.contiguous()
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 12)(*(s for x in (r, k, v, w)
                                      for s in x.stride()[:3]))
    lib = build.load()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.lib.mapple_wkv6_f32(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), state.data_ptr(), ctypes.addressof(strides), B, T, H, N,
        stream)
    build.check(lib, err, "wkv6")
    tracing.count("kernel.wkv6.launches")
    return y, state



def occupancy(N: int) -> tuple[int, int]:
    """Registers per thread and resident warps per SM of the kernel that a
    launch at head size ``N`` runs, as the CUDA runtime reports them."""
    regs, warps = ctypes.c_int(), ctypes.c_int()
    lib = build.load()
    err = lib.lib.mapple_wkv6_occupancy(N, ctypes.byref(regs), ctypes.byref(warps))
    build.check(lib, err, "wkv6 occupancy query")
    return regs.value, warps.value
