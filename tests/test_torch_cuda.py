"""The hand-written CUDA kernels on the card (skipped without one).

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs,
at the JAX package's kernel tolerances (fp32 1e-4, bf16 2e-2; float64
segment_rowmax 1e-12), and the pricing engine on the card against the
NumPy engine (1e-6 relative).
"""
import pytest
import torch

from repro_torch import apps
from repro_torch.apps import validate
from repro_torch.kernels import ops, ref
from repro_torch.kernels import causal_conv as cc_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import mamba_scan as ms_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import stencil as st_mod
from repro_torch.kernels import wkv6 as wkv_mod

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch finds no CUDA card)")
    ref.no_tf32()
    ops.reset_launch_counts()
    yield torch.device("cuda")
    ops.reset_launch_counts()


@pytest.mark.parametrize("shape", [
    (1, 128, 128, 128), (3, 1000, 777, 513), (2, 1, 5, 3), (4, 256, 2048, 64),
    # the fp32 kernel's slice edges (8-deep slices of 128 x 128 tiles); K and
    # N multiples of 4 take the float4 path, the others the scalar one
    (2, 70, 4, 36),             # K below one slice, float4 path
    (2, 70, 5, 36),             # K below one slice, scalar path
    (1, 200, 20, 136),          # K not a multiple of the slice, float4 path
    (1, 200, 13, 136),          # K not a multiple of the slice, scalar path
    (1, 129, 64, 129),          # M and N one past a tile
    (2, 129, 64, 132),          # M one past a tile, N one float4 past
    (8, 2048, 2048, 2048),      # Johnson / COSMA block shape, batch 8
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(card, shape, dtype):
    b, m, k, n = shape
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn((b, m, k), generator=gen, device=card).to(dtype)
    w = torch.randn((b, k, n), generator=gen, device=card).to(dtype)
    out = mm_mod.matmul_cuda(a, w)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (b, m, n)
    torch.testing.assert_close(out.float(), ref.matmul(a, w).float(), **TOL[dtype])
    assert ops.launch_counts()["matmul"] == 1


@pytest.mark.parametrize("shape,misaligned", [
    # the bf16 kernel's tile edges (128 x 256 tiles, 64-deep stages): M
    # 127-129 and 200, N 255-257, K 63-65 and 777, batch 1 and 3; K or N
    # off a multiple of 8 takes the padded route
    ((1, 127, 63, 255), False), ((3, 128, 64, 256), False), ((1, 129, 65, 257), False),
    ((3, 200, 777, 256), False), ((1, 128, 64, 257), False), ((3, 129, 64, 255), False),
    ((1, 200, 63, 256), False), ((3, 127, 65, 256), False),
    ((2, 200, 64, 256), True),  # a 8 bytes off 16: copied
])
def test_matmul_bf16_kernel_tile_edges(card, shape, misaligned):
    b, m, k, n = shape
    gen = torch.Generator(device=card).manual_seed(m * n + k)
    if misaligned:
        a = torch.randn((b * m * k + 4,), generator=gen, device=card).bfloat16()[4:]
        a = a.view(b, m, k)
        assert a.data_ptr() % 16 == 8
    else:
        a = torch.randn((b, m, k), generator=gen, device=card).bfloat16()
    w = torch.randn((b, k, n), generator=gen, device=card).bfloat16()
    out = mm_mod.matmul_cuda(a, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (b, m, n)
    torch.testing.assert_close(out.float(), ref.matmul(a, w).float(), **TOL[torch.bfloat16])
    assert ops.launch_counts()["matmul"] == 1


@pytest.mark.parametrize("shape", [(4, 2048, 2048, 2048), (8, 2048, 2048, 2048)])
def test_matmul_bf16_app_blocks_reach_the_kernel_unpadded(card, shape):
    """Every app block shape goes to the bf16 kernel as it is: the layout
    step neither pads nor copies it."""
    b, m, k, n = shape
    a = torch.randn((b, m, k), device=card).bfloat16()
    w = torch.randn((b, k, n), device=card).bfloat16()
    a2, w2 = mm_mod.tma_operands(a, w)
    assert a2 is a and w2 is w


def test_matmul_kernel_broadcast_operand(card):
    a = torch.randn((2, 1, 64, 96), device=card).expand(2, 3, 64, 96)
    w = torch.randn((1, 3, 96, 32), device=card).expand(2, 3, 96, 32)
    torch.testing.assert_close(ops.matmul(a, w), ref.matmul(a, w), **TOL[torch.float32])


@pytest.mark.parametrize("shape,interior", [
    ((1, 1), False), ((1, 33), False), ((37, 1), False), ((130, 70), False),
    ((2, 3, 64, 257), False), ((3, 3), True), ((130, 70), True),
    ((2, 3, 66, 259), True),
])
def test_stencil_kernel_matches_plain(card, shape, interior):
    x = torch.randn(shape, device=card)
    out = st_mod.stencil_cuda(x, interior=interior)
    expect = ref.stencil_interior(x) if interior else ref.stencil(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, expect, **TOL[torch.float32])
    assert ops.launch_counts()["stencil"] == 1


@pytest.mark.parametrize("name", list(apps.PAPER_APPS))
def test_apps_on_the_card(card, name):
    app = apps.get(name)
    res = validate.run(app, device="cuda")
    assert res["ok"], res
    if app.kind == apps.MATMUL:
        assert ops.launch_counts()["matmul"] > 0
    if name == "stencil":
        assert ops.launch_counts()["stencil"] > 0


# ------------------------------------------------------------ segment rowmax
SR_TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12),
          torch.float32: dict(rtol=1e-4, atol=1e-4)}


@pytest.mark.parametrize("shape", [(2048, 4096), (1000, 780), (7, 8), (1, 64),
                                   (3, 1000)])
@pytest.mark.parametrize("seg", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_segment_rowmax_kernel_matches_plain(card, shape, seg, dtype):
    rows, cols = shape
    cols -= cols % seg
    gen = torch.Generator(device=card).manual_seed(seg)
    vals = torch.rand((rows, cols), generator=gen, device=card, dtype=dtype)
    out = sr_mod.segment_rowmax_cuda(vals, seg)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (rows,)
    torch.testing.assert_close(out, ref.segment_rowmax(vals, seg), **SR_TOL[dtype])
    assert ops.launch_counts()["segment_rowmax"] == 1


def test_segment_rowmax_kernel_refuses_ragged_segments(card):
    with pytest.raises(ValueError, match="divide"):
        sr_mod.segment_rowmax_cuda(torch.rand((4, 10), device=card), 4)
    assert ops.launch_counts()["segment_rowmax"] == 0


@pytest.mark.parametrize("name", list(apps.PAPER_APPS))
def test_pricer_on_the_card_matches_numpy_engine(card, name):
    """The torch engine on the card (kernel reduction) against the port's
    NumPy engine on seeded random placements, and the kernel counter
    rising for the dense schedule."""
    import numpy as np

    from repro_torch.sim.cost import time_search_space
    from repro_torch.sim.torch_backend import _export_for, to_torch

    app = apps.get(name)
    space = time_search_space(app)
    model = space.cost_model(256, dict(space.default_options))
    grid = next(g for g in app.search_space.grids(256) if _simulable(model, g))
    eng = model.batch(grid)
    stack = np.stack([np.random.default_rng(i).permutation(256) for i in range(6)])
    got = to_torch(eng, device="cuda").step_times(stack)
    np.testing.assert_allclose(got, eng.step_times(stack), rtol=1e-6, atol=0)
    if _export_for(eng.schedule, eng.topology).mode == "dense":
        assert ops.launch_counts()["segment_rowmax"] > 0
    handle = to_torch(eng, device="cuda").step_times_async(stack)
    np.testing.assert_array_equal(handle.result(), got)


def _simulable(model, grid) -> bool:
    try:
        model._validate(grid)
    except ValueError:
        return False
    return True


# ---------------------------------------------------------- flash attention
@pytest.mark.parametrize("B,S,H,Kv,d,window,causal", [
    (1, 64, 1, 1, 64, 0, True),
    (2, 200, 4, 2, 64, 0, True),          # ragged S, GQA
    (4, 2048, 25, 5, 64, 1024, True),     # hymba-1.5b prefill
    (4, 2048, 9, 3, 64, 0, True),         # smollm-135m prefill
    (1, 300, 6, 3, 80, 100, True),        # danube's head dim, window
    (2, 129, 4, 1, 128, 0, True),         # qwen2's head dim
    (1, 77, 2, 2, 16, 0, False),          # not causal
    (1, 130, 2, 1, 32, 40, False),        # not causal, window
    (3, 5, 3, 3, 48, 2, True),            # shorter than one tile
    # the bf16 kernel's tile edges (64 queries, 64 keys a tile)
    (2, 63, 4, 2, 64, 0, True),           # S = BQ - 1
    (2, 64, 4, 2, 64, 0, True),           # S = BQ
    (2, 65, 4, 2, 64, 0, True),           # S = BQ + 1
    (1, 129, 6, 2, 64, 0, True),          # S = 2 BK + 1
    (2, 300, 4, 2, 64, 37, True),         # window ends inside a key tile
    (1, 512, 4, 1, 64, 128, True),        # window a multiple of BK
    (2, 257, 4, 2, 64, 64, False),        # not causal, window
    (2, 256, 4, 2, 16, 0, True),          # d = 16 at S >= 256
    (1, 320, 4, 2, 128, 100, True),       # d = 128 at S >= 256, window
    # the fp32 kernel's tile edges (128 queries at d <= 64, 64 above)
    (2, 127, 4, 2, 64, 0, True),          # S = BQ - 1
    (2, 128, 4, 2, 64, 0, True),          # S = BQ
    (2, 129, 4, 2, 64, 0, True),          # S = BQ + 1
    (2, 65, 4, 2, 128, 0, True),          # S = BQ + 1 at d = 128
    (1, 257, 4, 2, 16, 0, True),          # d = 16, two query tiles and one row
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(card, B, S, H, Kv, d, window, causal,
                                              dtype):
    gen = torch.Generator(device=card).manual_seed(S)
    q = torch.randn((B, S, H, d), generator=gen, device=card).to(dtype)
    k = torch.randn((B, S, Kv, d), generator=gen, device=card).to(dtype)
    v = torch.randn((B, S, Kv, d), generator=gen, device=card).to(dtype)
    out = fa_mod.flash_attention_cuda(q, k, v, window=window, causal=causal)
    expect = ops.flash_attention_plain(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (B, S, H, d)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])
    assert ops.launch_counts()["flash_attention"] == 1


def test_flash_attention_kernel_reads_strided_layout(card):
    """A transposed (non-contiguous) q and a custom scale."""
    q = torch.randn((2, 4, 96, 64), device=card).transpose(1, 2)
    k = torch.randn((2, 96, 2, 64), device=card)
    v = torch.randn((2, 96, 2, 64), device=card)
    out = ops.flash_attention(q, k, v, scale=0.2, window=30)
    expect = ops.flash_attention_plain(q, k, v, scale=0.2, window=30)
    torch.testing.assert_close(out, expect, **TOL[torch.float32])


def test_flash_attention_bf16_kernel_copies_misaligned_operands(card):
    """A bf16 k whose heads start 4 elements into a padded row (pointer
    not 16-byte aligned, seq stride not a multiple of 8): the wrapper
    copies it, and the kernel's answer stays right."""
    B, S, H, Kv, d = 2, 200, 4, 2, 64
    gen = torch.Generator(device=card).manual_seed(11)
    q = torch.randn((B, S, H, d), generator=gen, device=card).to(torch.bfloat16)
    padded = torch.randn((B, S, Kv * d + 4), generator=gen, device=card).to(torch.bfloat16)
    k = padded[..., 4:].unflatten(-1, (Kv, d))
    v = torch.randn((B, S, Kv, d), generator=gen, device=card).to(torch.bfloat16)
    assert not fa_mod.kernel_ready(k) and fa_mod.kernel_ready(q)
    out = fa_mod.flash_attention_cuda(q, k, v, window=50)
    expect = ops.flash_attention_plain(q, k, v, window=50)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), expect.float(), **TOL[torch.bfloat16])
    assert ops.launch_counts()["flash_attention"] == 1


def test_flash_attention_fp32_kernel_copies_misaligned_operands(card):
    """An fp32 k whose heads start 2 floats into a padded row (pointer 8
    bytes off 16, seq stride 2 mod 4): the wrapper copies it, and the
    kernel's answer stays right."""
    B, S, H, Kv, d = 2, 200, 4, 2, 64
    gen = torch.Generator(device=card).manual_seed(12)
    q = torch.randn((B, S, H, d), generator=gen, device=card)
    padded = torch.randn((B, S, Kv * d + 2), generator=gen, device=card)
    k = padded[..., 2:].unflatten(-1, (Kv, d))
    v = torch.randn((B, S, Kv, d), generator=gen, device=card)
    assert not fa_mod.kernel_ready(k) and fa_mod.kernel_ready(q)
    out = fa_mod.flash_attention_cuda(q, k, v, window=50)
    expect = ops.flash_attention_plain(q, k, v, window=50)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, expect, **TOL[torch.float32])
    assert ops.launch_counts()["flash_attention"] == 1


def test_flash_attention_kernel_refuses_what_it_does_not_take(card):
    q = torch.randn((1, 8, 3, 64), device=card)
    with pytest.raises(ValueError, match="multiple"):
        fa_mod.flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="head dim"):
        fa_mod.flash_attention_cuda(q[..., :40], q[..., :40], q[..., :40])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_mod.flash_attention_cuda(q.half(), q.half(), q.half())
    assert ops.launch_counts()["flash_attention"] == 0


# --------------------------------------------------------------- mamba scan
@pytest.mark.parametrize("B,T,di,n", [(4, 2048, 3200, 16), (2, 100, 24, 8),
                                      (1, 33, 7, 4), (3, 64, 130, 32),
                                      # a ragged last 32-channel block, T not a
                                      # multiple of the 32-step chunk, and
                                      # di % 4 != 0 (4-byte copies)
                                      (2, 100, 200, 16), (2, 45, 96, 4),
                                      (2, 50, 100, 32), (1, 77, 70, 32)])
def test_mamba_scan_kernel_matches_plain(card, B, T, di, n):
    gen = torch.Generator(device=card).manual_seed(T)
    xs = 0.5 * torch.randn((B, T, di), generator=gen, device=card)
    dt = 0.2 * torch.nn.functional.softplus(
        torch.randn((B, T, di), generator=gen, device=card))
    Bs = 0.5 * torch.randn((B, T, n), generator=gen, device=card)
    Cs = 0.5 * torch.randn((B, T, n), generator=gen, device=card)
    A = -torch.exp(0.3 * torch.randn((di, n), generator=gen, device=card))
    y, s = ms_mod.mamba_scan_cuda(xs, dt, Bs, Cs, A)
    y_ref, s_ref = ref.mamba_scan(xs, dt, Bs, Cs, A)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **TOL[torch.float32])
    torch.testing.assert_close(s, s_ref, **TOL[torch.float32])
    assert ops.launch_counts()["mamba_scan"] == 1


def test_mamba_scan_kernel_reads_misaligned_rows(card):
    """Contiguous inputs that start 4 bytes past a 16-byte boundary take the
    kernel's 4-byte copies."""
    B, T, di, n = 2, 40, 128, 16
    gen = torch.Generator(device=card).manual_seed(7)
    xs = 0.5 * torch.randn((B, T, di), generator=gen, device=card)
    dt = 0.2 * torch.nn.functional.softplus(
        torch.randn((B, T, di), generator=gen, device=card))
    Bs = 0.5 * torch.randn((B, T, n), generator=gen, device=card)
    Cs = 0.5 * torch.randn((B, T, n), generator=gen, device=card)
    A = -torch.exp(0.3 * torch.randn((di, n), generator=gen, device=card))

    def shifted(x):
        out = torch.empty(1 + x.numel(), device=card)[1:].view(x.shape)
        return out.copy_(x)

    xs2, dt2, Bs2, Cs2 = (shifted(x) for x in (xs, dt, Bs, Cs))
    assert xs2.data_ptr() % 16 == 4 and xs2.is_contiguous()
    y, s = ms_mod.mamba_scan_cuda(xs2, dt2, Bs2, Cs2, A)
    y_ref, s_ref = ref.mamba_scan(xs, dt, Bs, Cs, A)
    torch.testing.assert_close(y, y_ref, **TOL[torch.float32])
    torch.testing.assert_close(s, s_ref, **TOL[torch.float32])


# ------------------------------------------------------ Hymba's mixer kernels
# chip_smoke.py's LM shape and the hymba-prefill-32k cell's (d_inner 3200,
# state 16, conv 4), then the edges: T = 1, T < W-1, T off the 8-step conv
# chunk and the 32-step scan chunk, a ragged last 32-channel block, d_inner
# off a multiple of 8 and of 4 (one element a copy), states 4 (bf16 rows
# under 16 bytes), 8 and 32 (each with its own helper-warp layout).
MIXER_SHAPES = [(4, 2048, 3200, 16, 4), (2, 32768, 3200, 16, 4)]
MIXER_EDGES = [(1, 1, 16, 8, 4), (2, 2, 24, 8, 4), (3, 37, 100, 4, 4), (2, 50, 70, 32, 4),
               (2, 45, 96, 4, 4), (2, 100, 200, 16, 4), (1, 77, 72, 32, 4), (2, 33, 64, 8, 4)]


def _mixer_inputs(card, B, T, di, n, W, dtype, seed):
    """The mixer's tensors in its own layouts: xz (B,T,2di) whose halves the
    kernels read in place, bc (B,T,2n) likewise; dt_raw around the bias so
    that softplus(dt_raw + dt_bias) lies near 0.2, with some entries past
    torch's threshold of 20."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card)

    xz = randn(B, T, 2 * di).to(dtype)
    w = (0.5 * randn(W, di)).to(dtype)
    tail = randn(B, W - 1, di).to(dtype)
    dt_raw = randn(B, T, di)
    dt_raw[..., ::97] += 25.0
    bc = (0.5 * randn(B, T, 2 * n)).to(dtype)
    A = -torch.exp(0.3 * randn(di, n))
    dt_bias = -1.5 + 0.1 * randn(di)
    D = randn(di).to(dtype)
    return xz, w, tail, dt_raw.to(dtype), bc, A, dt_bias, D


@pytest.mark.parametrize("B,T,di,n,W", MIXER_SHAPES + MIXER_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_kernel_matches_plain(card, B, T, di, n, W, dtype, with_tail):
    """The conv + SiLU on xz's first half in place, against its plain twin:
    y and the new tail (the conv's last W-1 inputs, exact)."""
    xz, w, tail, *_ = _mixer_inputs(card, B, T, di, n, W, dtype, seed=T + W)
    tail = tail if with_tail else None
    y, new_tail = cc_mod.causal_conv_silu_cuda(xz[..., :di], w, tail)
    y_ref, tail_ref = ops.causal_conv_silu_plain(xz[..., :di], w, tail)
    torch.cuda.synchronize()
    assert y.is_contiguous() and y.dtype == dtype and new_tail.shape == (B, W - 1, di)
    torch.testing.assert_close(y, y_ref, **TOL[dtype])
    torch.testing.assert_close(new_tail, tail_ref, rtol=0, atol=0)
    assert ops.launch_counts()["causal_conv"] == 1


@pytest.mark.parametrize("B,T,di,n,W", MIXER_SHAPES + MIXER_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_gated_kernel_matches_plain(card, B, T, di, n, W, dtype):
    """The gated scan on the mixer's raw tensors (bc's halves and xz's second
    half in place) against its plain twin: y and the final state."""
    xz, _, _, dt_raw, bc, A, dt_bias, D = _mixer_inputs(card, B, T, di, n, W, dtype, seed=T)
    xs = torch.nn.functional.silu(xz[..., :di].float()).to(dtype)
    args = (xs, dt_raw, bc[..., :n], bc[..., n:], A, dt_bias, D, xz[..., di:])
    y, s = ms_mod.mamba_scan_gated_cuda(*args)
    y_ref, s_ref = ops.mamba_scan_gated_plain(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y, y_ref, **TOL[dtype])
    torch.testing.assert_close(s, s_ref, **TOL[torch.float32])
    assert ops.launch_counts()["mamba_scan"] == 1


def test_mixer_kernels_refuse_what_they_do_not_take(card):
    """Each wrapper raises before any launch on a dtype, shape or stride it
    does not read: fp16, mixed dtypes, W = 5 and 3, a state of 12, a transposed
    view, channels at a stride, rows unevenly spaced across the batch, a
    non-contiguous D, a CPU tensor."""
    B, T, di, n, W = 2, 40, 64, 16, 4
    xz, w, tail, dt_raw, bc, A, dt_bias, D = _mixer_inputs(card, B, T, di, n, W,
                                                           torch.bfloat16, seed=1)
    x = xz[..., :di]
    conv = cc_mod.causal_conv_silu_cuda
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv(x.half(), w.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv(x, w.float())
    with pytest.raises(ValueError, match="width is 4"):
        conv(x, torch.cat([w, w[:1]]))
    with pytest.raises(ValueError, match="width is 4"):
        conv(x, w[:3])
    with pytest.raises(ValueError, match="not read in place"):
        conv(x[..., ::2], w[:, ::2])
    with pytest.raises(ValueError, match="not read in place"):
        conv(torch.cat([x, x], dim=1)[:, :T], w)
    with pytest.raises(ValueError, match="contiguous"):
        conv(x, w, tail.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="CUDA"):
        conv(x, w.cpu())
    xs = xz[..., :di].contiguous()
    z = xz[..., di:]
    scan = ms_mod.mamba_scan_gated_cuda
    good = (xs, dt_raw, bc[..., :n], bc[..., n:], A, dt_bias, D, z)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scan(*(t.half() if t.dtype == torch.bfloat16 else t for t in good))
    with pytest.raises(ValueError, match="dt_bias"):
        scan(*good[:5], dt_bias.bfloat16(), *good[6:])
    with pytest.raises(ValueError, match="state size"):
        scan(xs, dt_raw, bc[..., :12], bc[..., 12:24], A[:, :12].contiguous(), dt_bias, D, z)
    with pytest.raises(ValueError, match="not read in place"):
        scan(xs.transpose(0, 1).contiguous().transpose(0, 1), *good[1:])
    with pytest.raises(ValueError, match="not read in place"):
        scan(xs, dt_raw, bc[..., :2 * n:2], *good[3:])
    with pytest.raises(ValueError, match="contiguous"):
        scan(*good[:6], torch.stack([D, D], 1)[:, 0], z)
    with pytest.raises(ValueError, match="CUDA"):
        scan(*good[:7], z.cpu())
    assert ops.launch_counts()["causal_conv"] == 0 and ops.launch_counts()["mamba_scan"] == 0


# --------------------------------------------------------------------- wkv6
def _wkv6_inputs(card, B, T, H, N, seed):
    """Drawn as tests/test_kernels.py::test_wkv6_shapes draws them."""
    gen = torch.Generator(device=card).manual_seed(seed)
    r, k, v = (0.5 * torch.randn((B, T, H, N), generator=gen, device=card)
               for _ in range(3))
    w = torch.sigmoid(torch.randn((B, T, H, N), generator=gen, device=card)) * 0.5 + 0.4
    u = 0.1 * torch.randn((H, N), generator=gen, device=card)
    return r, k, v, w, u


@pytest.mark.parametrize("B,T,H,N", [(4, 2048, 40, 64),    # rwkv6-3b prefill
                                     (2, 1000, 3, 64),     # ragged T
                                     (1, 1, 2, 64), (3, 33, 5, 32), (2, 100, 4, 16),
                                     (1, 31, 1, 16),
                                     # T short of, one past and ragged against the
                                     # 16-step chunk at N = 64, 32 and 16 (one block
                                     # a head at 32 and 16)
                                     (2, 15, 3, 64), (1, 17, 2, 64), (2, 17, 3, 32),
                                     (3, 47, 2, 16), (1, 2, 5, 32), (1, 1, 3, 16)])
def test_wkv6_kernel_matches_plain(card, B, T, H, N):
    r, k, v, w, u = _wkv6_inputs(card, B, T, H, N, seed=T)
    y, s = wkv_mod.wkv6_cuda(r, k, v, w, u)
    y_ref, s_ref = ops.wkv6_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    assert y.shape == (B, T, H, N) and s.shape == (B, H, N, N)
    torch.testing.assert_close(y, y_ref, **TOL[torch.float32])
    torch.testing.assert_close(s, s_ref, **TOL[torch.float32])
    assert ops.launch_counts()["wkv6"] == 1


def test_wkv6_kernel_reads_strided_layout(card):
    """r/k/v as (B,H,T,N) storage viewed as (B,T,H,N), and w a slice of a
    wider tensor: read in place through their strides."""
    B, T, H, N = 2, 77, 3, 32
    r, k, v, w, u = _wkv6_inputs(card, B, T, H, N, seed=5)
    r2, k2, v2 = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (r, k, v))
    w2 = torch.cat([w, w], dim=-1)[..., :N]
    y, s = ops.wkv6(r2, k2, v2, w2, u)
    y_ref, s_ref = ops.wkv6_plain(r, k, v, w, u)
    torch.testing.assert_close(y, y_ref, **TOL[torch.float32])
    torch.testing.assert_close(s, s_ref, **TOL[torch.float32])


@pytest.mark.parametrize("N", [64, 32, 16])
def test_wkv6_kernel_reads_misaligned_rows(card, N):
    """Rows that start 4 bytes past a 16-byte boundary take the kernel's
    4-byte copies."""
    B, T, H = 2, 37, 3
    r, k, v, w, u = _wkv6_inputs(card, B, T, H, N, seed=6)
    r2, k2, v2, w2 = (torch.cat([x[..., :1], x], dim=-1)[..., 1:] for x in (r, k, v, w))
    assert r2.data_ptr() % 16 == 4
    y, s = wkv_mod.wkv6_cuda(r2, k2, v2, w2, u)
    y_ref, s_ref = ops.wkv6_plain(r, k, v, w, u)
    torch.testing.assert_close(y, y_ref, **TOL[torch.float32])
    torch.testing.assert_close(s, s_ref, **TOL[torch.float32])


def test_wkv6_kernel_refuses_what_it_does_not_take(card):
    x, u = torch.ones((1, 8, 2, 64), device=card), torch.ones((2, 64), device=card)
    with pytest.raises(ValueError, match="float32"):
        wkv_mod.wkv6_cuda(x.bfloat16(), x, x, x, u)
    with pytest.raises(ValueError, match="head size"):
        wkv_mod.wkv6_cuda(x[..., :8], x[..., :8], x[..., :8], x[..., :8], u[:, :8])
    with pytest.raises(ValueError, match="CUDA"):
        wkv_mod.wkv6_cuda(x, x, x, x.cpu(), u)
    assert ops.launch_counts()["wkv6"] == 0


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-1.8b", "hymba-1.5b"])
def test_reduced_prefill_through_the_kernels(card, arch):
    """A reduced model's prefill with the kernels against the plain one
    (fp32; hymba at the mixer tolerance of tests/test_kernels.py)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build

    model = build(get_config(arch).reduced())
    params = model.init(torch.Generator(device=card).manual_seed(0), device=card)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 150), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    got = make_prefill_step(model)(params, toks)
    counts = ops.launch_counts()
    want = make_prefill_step(model, use_kernel=False)(params, toks)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-2, atol=5e-2) if arch == "hymba-1.5b" else dict(rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got, want, **tol)
    assert counts["flash_attention"] == model.cfg.n_layers
    for name in ("causal_conv", "mamba_scan"):
        assert counts[name] == (model.cfg.n_layers if arch == "hymba-1.5b" else 0)


@pytest.mark.parametrize("d_model", [64, 128])
def test_reduced_rwkv6_prefill_through_the_kernel(card, d_model):
    """A reduced RWKV-6 prefill with the WKV6 kernel against the plain one
    (fp32): one launch per layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build

    model = build(dataclasses.replace(get_config("rwkv6-3b").reduced(),
                                      d_model=d_model))
    params = model.init(torch.Generator(device=card).manual_seed(0), device=card)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 150), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    got = make_prefill_step(model)(params, toks)
    counts = ops.launch_counts()
    want = make_prefill_step(model, use_kernel=False)(params, toks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    assert counts["wkv6"] == model.cfg.n_layers
    assert counts["flash_attention"] == 0 and counts["mamba_scan"] == 0
    assert counts["causal_conv"] == 0


# ----------------------------------------------------------------- dry run
RECORD_FIELDS = ("status", "flops", "bytes_accessed", "bytes_unfused", "argument_bytes",
                 "collective_bytes", "collectives", "roofline", "n_chips", "run_s", "count_s",
                 "batch", "step_s", "peak_memory_bytes", "launches", "roofline_share",
                 "bytes_unfused_per_s_upper", "flops_at_batch", "model_flops_at_batch",
                 "reduced")
ROOFLINE_FIELDS = ("compute_s", "memory_s", "collective_s", "bottleneck", "model_flops",
                   "useful_flops_ratio")


@pytest.mark.parametrize("arch,kernels,tol", [
    ("hymba-1.5b", ("flash_attention", "causal_conv", "mamba_scan"),
     dict(rtol=1e-2, atol=5e-2)),
    ("rwkv6-3b", ("wkv6",), dict(rtol=2e-3, atol=2e-3)),
])
def test_dryrun_prefill_32k_cell_on_the_card(card, arch, kernels, tol):
    """run_cell on the card: a reduced prefill at S = 32768 (B=1, cut from
    32) launches each of its kernels once a layer, its record has every
    field, and the kernel route matches the plain route on the same
    weights (fp32; the limits of the reduced prefill tests above)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.config import SHAPES

    cfg = get_config(arch).reduced()
    rec = dryrun.run_cell(arch, "prefill_32k", device="cuda", batch=1, cfg=cfg, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert all(f in rec for f in RECORD_FIELDS)
    assert all(f in rec["roofline"] for f in ROOFLINE_FIELDS)
    assert rec["n_chips"] == 1 and rec["collective_bytes"] == 0.0
    assert rec["reduced"] == {"global_batch": [32, 1]} and rec["batch"] == 1
    assert rec["launches"] == {k: cfg.n_layers if k in kernels else 0
                               for k in ops.launch_counts()}
    assert rec["step_s"] > 0 and rec["peak_memory_bytes"] > 0
    assert rec["model_flops_at_batch"] == pytest.approx(rec["roofline"]["model_flops"] / 32)
    assert rec["roofline_share"] == pytest.approx(
        rec["model_flops_at_batch"] / 989e12 / rec["step_s"])
    assert rec["output_shape"] == [1, 1, cfg.padded_vocab]
    model, params, (toks,) = dryrun.card_inputs(cfg, SHAPES["prefill_32k"], 1)
    got = make_prefill_step(model)(params, toks)
    want = make_prefill_step(model, use_kernel=False)(params, toks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **tol)
