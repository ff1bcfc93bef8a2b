"""The port's kernels on the CPU: plain versions against the Pallas kernels.

On the CPU, ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; these tests hold those against the JAX package's Pallas kernels
in interpret mode, on the same numpy-seeded inputs, at the shapes, dtypes
and tolerances of ``tests/test_kernels.py``. The CUDA kernels themselves
run only on a card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.matmul import matmul_pallas
from repro.kernels.segment_reduce import segment_rowmax_pallas
from repro.kernels.stencil import stencil_pallas
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import causal_conv as cc_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import mamba_scan as ms_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import stencil as st_mod
from repro_torch.kernels import wkv6 as wkv_mod

# The fp32 and bf16 tolerances of tests/test_kernels.py (blocked-vs-flat
# accumulation order at k ~ 512; bf16 rounding).
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NO_LAUNCHES = {"matmul": 0, "stencil": 0, "segment_rowmax": 0,
               "flash_attention": 0, "mamba_scan": 0, "wkv6": 0, "causal_conv": 0}


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(out_torch, expect_jax, dtype):
    np.testing.assert_allclose(
        out_torch.to(torch.float32).numpy(),
        np.asarray(expect_jax, np.float32), **TOL[dtype])


@pytest.fixture(autouse=True)
def _fresh_counts():
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


# ------------------------------------------------------------------- matmul
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 512, 256), (384, 128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matmul_matches_pallas(m, k, n, dtype):
    a, b = _normal(0, (m, k)), _normal(1, (k, n))
    expect = matmul_pallas(jnp.asarray(a).astype(JNP[dtype]),
                           jnp.asarray(b).astype(JNP[dtype]), interpret=True)
    out = ops.matmul(torch.from_numpy(a).to(TORCH[dtype]),
                     torch.from_numpy(b).to(TORCH[dtype]))
    assert out.dtype == TORCH[dtype]
    _close(out, expect, dtype)
    assert ops.launch_counts() == NO_LAUNCHES


def test_plain_matmul_batched_is_per_rank_product():
    """The stacked-rank batch (with a broadcast operand) is one product per
    rank, as the kernel computes it in one launch."""
    a = torch.from_numpy(_normal(2, (2, 3, 32, 48)))
    b = torch.from_numpy(_normal(3, (1, 3, 48, 16))).expand(2, 3, 48, 16)
    out = ops.matmul(a, b)
    for i in range(2):
        for j in range(3):
            np.testing.assert_allclose(
                out[i, j].numpy(), np.asarray(jref.matmul(
                    jnp.asarray(a[i, j].numpy()), jnp.asarray(b[i, j].numpy()))),
                **TOL["float32"])


# ------------------------------------------------------------------ stencil
@pytest.mark.parametrize("m,n,bm", [(128, 128, 64), (256, 128, 128),
                                    (192, 256, 64)])
def test_plain_stencil_matches_pallas(m, n, bm):
    f = _normal(0, (m, n))
    expect = stencil_pallas(jnp.asarray(f), bm=bm, interpret=True)
    out = ops.stencil_step(torch.from_numpy(f))
    _close(out, expect, "float32")
    assert ops.launch_counts() == NO_LAUNCHES


def test_plain_stencil_interior_is_the_padded_sweep():
    """The interior sweep over an edge-padded field is the edge-replicate
    step, and over each rank's padded block the oracle's sweep."""
    f = _normal(4, (3, 40, 24))
    padded = np.pad(f, ((0, 0), (1, 1), (1, 1)), mode="edge")
    out = ops.stencil_interior(torch.from_numpy(padded))
    for r in range(3):
        _close(out[r], jref.stencil(jnp.asarray(f[r])), "float32")
    torch.testing.assert_close(out, ops.stencil_step(torch.from_numpy(f)),
                               rtol=0, atol=0)
    assert ops.launch_counts() == NO_LAUNCHES


# ----------------------------------------------------------- segment rowmax
# The shapes of tests/test_kernels.py's segment_rowmax tests; float64 is
# the pricer's default dtype.
SR_SHAPES = [(5, 512, 1), (8, 512, 8), (17, 96, 4), (3, 1024, 64), (1, 64, 64),
             (13, 256, 8), (6, 192, 4), (9, 300, 1)]
SR_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
          "float64": dict(rtol=1e-12, atol=1e-12)}


@pytest.mark.parametrize("rows,cols,seg", SR_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_segment_rowmax_matches_pallas(rows, cols, seg, dtype):
    vals = np.abs(np.random.default_rng(rows * cols + seg)
                  .normal(size=(rows, cols))).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        expect = np.asarray(segment_rowmax_pallas(jnp.asarray(vals), seg,
                                                  interpret=True))
    assert expect.dtype == np.dtype(dtype)
    out = ops.segment_rowmax(torch.from_numpy(vals), seg)
    assert out.dtype == getattr(torch, dtype) and out.shape == (rows,)
    np.testing.assert_allclose(out.numpy(), expect, **SR_TOL[dtype])
    assert ops.launch_counts() == NO_LAUNCHES


def test_plain_segment_rowmax_seg_one_is_row_max():
    vals = torch.rand((9, 300), dtype=torch.float64)
    torch.testing.assert_close(ops.segment_rowmax(vals), vals.amax(1),
                               rtol=0, atol=0)


# ----------------------------------------------------------------- dispatch
def test_wrappers_refuse_non_cuda_tensors():
    """A wrapper launches on a CUDA tensor or raises: never a silent plain
    path, and a refused call launches nothing."""
    a = torch.ones(4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        mm_mod.matmul_cuda(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        st_mod.stencil_cuda(a, interior=False)
    with pytest.raises(ValueError, match="CUDA"):
        ops.matmul(a.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.stencil_step(a.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        sr_mod.segment_rowmax_cuda(a, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ops.segment_rowmax(a.to("meta"), 2)
    assert ops.launch_counts() == NO_LAUNCHES


def test_build_needs_nvcc_and_keys_on_sources(monkeypatch, tmp_path):
    digest = build.source_digest()
    assert digest == build.source_digest() and len(digest) == 16
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_build_compiles_every_kernel_source():
    """Every CUDA source in csrc/ is built, and has a bound entry point."""
    assert sorted(build.SOURCES) == sorted(p.name for p in build.CSRC.glob("*.cu"))
    texts = [(build.CSRC / src).read_text() for src in build.SOURCES]
    for name in build.SIGNATURES:
        assert sum(f'extern "C" int {name}(' in t for t in texts) == 1, name


@pytest.mark.parametrize("b,m,k,n", [(2, 5, 13, 21), (1, 3, 7, 8), (3, 4, 16, 9),
                                     (1, 129, 65, 257), (2, 6, 777, 30)])
def test_tma_operands_pad_ragged_k_and_n(b, m, k, n):
    """The bf16 kernel's layout step: K and N zero-padded to multiples of 8.
    Pad, take the plain product and slice: the unpadded product, exactly
    (small integers, so every fp32 sum is exact)."""
    rng = np.random.default_rng(k * n)
    a = torch.from_numpy(rng.integers(-2, 3, (b, m, k)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.integers(-2, 3, (b, k, n)).astype(np.float32)).bfloat16()
    a2, w2 = mm_mod.tma_operands(a, w)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    assert a2.shape == (b, m, kp) and w2.shape == (b, kp, np_)
    assert all(x.data_ptr() % 16 == 0 and x.is_contiguous() for x in (a2, w2))
    assert torch.equal(ref.matmul(a2, w2)[..., :n], ref.matmul(a, w))


@pytest.mark.parametrize("b,m,k,n", [(4, 2048, 2048, 2048), (8, 2048, 2048, 2048),
                                     (1, 64, 64, 64)])
def test_tma_operands_keep_app_block_shapes(b, m, k, n):
    """Every app block shape (K and N multiples of 8, fresh dense blocks)
    reaches the kernel as it is: no padding, no copy. A misaligned operand
    is copied to an aligned one with the same values."""
    a = torch.zeros((b, m, k), dtype=torch.bfloat16)
    w = torch.zeros((b, k, n), dtype=torch.bfloat16)
    a2, w2 = mm_mod.tma_operands(a, w)
    assert a2 is a and w2 is w
    moved = torch.randn(b * m * k + 4).bfloat16()[4:].view(b, m, k)
    assert moved.data_ptr() % 16 == 8
    a3, w3 = mm_mod.tma_operands(moved, w)
    assert a3 is not moved and a3.data_ptr() % 16 == 0 and torch.equal(a3, moved)
    assert w3 is w


def test_plain_matmul_keeps_fp32_out_of_tf32():
    ref.matmul(torch.ones(2, 2), torch.ones(2, 2))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# ---------------------------------------------------------- flash attention
def _qkv(seed, shape):
    return [_normal(seed + i, shape) for i in range(3)]


@pytest.mark.parametrize("s,d", [(128, 64), (256, 64), (256, 128)])
@pytest.mark.parametrize("window", [0, 64])
def test_plain_flash_attention_matches_pallas(s, d, window):
    """The shapes of tests/test_kernels.py::test_flash_attention_shapes."""
    from repro.kernels.flash_attention import flash_attention_pallas

    q, k, v = _qkv(20, (4, s, d))
    expect = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    window=window, bq=64, bk=64, interpret=True)
    out = ref.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    _close(out, expect, "float32")
    _close(out, jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     window=window), "float32")


@pytest.mark.parametrize("causal,window", [(False, 0), (False, 16), (True, 1)])
def test_plain_flash_attention_masks_match_jax_ref(causal, window):
    q, k, v = _qkv(23, (3, 40, 16))
    out = ref.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window,
                              causal=causal, scale=0.3)
    _close(out, jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     window=window, causal=causal, scale=0.3),
           "float32")


def test_plain_flash_attention_bf16_matches_pallas():
    q, k, v = _qkv(26, (2, 128, 64))
    from repro.kernels.flash_attention import flash_attention_pallas

    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    expect = flash_attention_pallas(jq, jk, jv, bq=64, bk=64, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = ref.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    _close(out, expect, "bfloat16")


@pytest.mark.parametrize("H,Kv,window", [(4, 2, 0), (4, 4, 32), (6, 3, 48)])
def test_ops_flash_attention_gqa_layout_matches_jax_ops(H, Kv, window):
    """The model-layout wrapper (GQA repeat, (B,S,H,hd) <-> (BH,S,hd))
    against repro.kernels.ops.flash_attention (Pallas in interpret mode)."""
    from repro.kernels import ops as jops

    B, S, hd = 2, 128, 32
    q = _normal(30, (B, S, H, hd))
    k, v = _normal(31, (B, S, Kv, hd)), _normal(32, (B, S, Kv, hd))
    expect = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=window)
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    assert out.shape == (B, S, H, hd)
    _close(out, expect, "float32")
    assert ops.launch_counts() == NO_LAUNCHES


def test_ops_flash_attention_any_length_is_naive_attention():
    """Serving prompts are not multiples of the tile: any S, against the
    JAX package's naive attention."""
    from repro.models import layers as jlayers

    q = _normal(33, (1, 37, 6, 16))
    k, v = _normal(34, (1, 37, 2, 16)), _normal(35, (1, 37, 2, 16))
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), window=20)
    _close(out, jlayers.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), window=20), "float32")


# --------------------------------------------------------------- mamba scan
def _mamba_inputs(B, t, di, n, seed=40):
    rng = np.random.default_rng(seed)
    xs = (0.5 * rng.normal(size=(B, t, di))).astype(np.float32)
    dt = (0.2 * np.log1p(np.exp(rng.normal(size=(B, t, di))))).astype(np.float32)
    Bs = (0.5 * rng.normal(size=(B, t, n))).astype(np.float32)
    Cs = (0.5 * rng.normal(size=(B, t, n))).astype(np.float32)
    A = (-np.exp(0.3 * rng.normal(size=(di, n)))).astype(np.float32)
    return xs, dt, Bs, Cs, A


@pytest.mark.parametrize("t,di,n,bt", [(64, 16, 8, 32), (128, 24, 8, 64),
                                       (128, 32, 16, 128)])
def test_plain_mamba_scan_matches_pallas(t, di, n, bt):
    """The shapes of tests/test_kernels.py::test_mamba_scan_shapes."""
    from repro.kernels.mamba_scan import mamba_scan_pallas

    args = _mamba_inputs(2, t, di, n)
    jargs = [jnp.asarray(a) for a in args]
    y_p, s_p = mamba_scan_pallas(*jargs, bt=bt, interpret=True)
    y_r, s_r = jref.mamba_scan(*jargs)
    y, s = ops.mamba_scan(*map(torch.from_numpy, args))
    assert y.shape == (2, t, di) and s.shape == (2, di, n) and s.dtype == torch.float32
    for out, expect in ((y, y_p), (s, s_p), (y, y_r), (s, s_r)):
        _close(out, expect, "float32")
    assert ops.launch_counts() == NO_LAUNCHES


def test_ops_mamba_scan_matches_jax_ops():
    from repro.kernels import ops as jops

    args = _mamba_inputs(3, 64, 20, 4, seed=41)
    y_j, s_j = jops.mamba_scan(*map(jnp.asarray, args))
    y, s = ops.mamba_scan(*map(torch.from_numpy, args))
    _close(y, y_j, "float32")
    _close(s, s_j, "float32")


# ------------------------------------------------------ Hymba's mixer kernels
def _conv_chain(x, w, tail):
    """The mixer's conv before the conv kernel: ``_causal_conv`` then SiLU,
    each operator rounded to x's dtype."""
    from repro_torch.models.hymba import _causal_conv

    y, new_tail = _causal_conv(x, w, tail)
    return torch.nn.functional.silu(y), new_tail


def _gated_chain(xs, dt_raw, Bs, Cs, A, dt_bias, D, z):
    """The mixer's zero-state kernel path before the gated scan: dt's cast,
    bias and softplus, fp32 copies for the plain scan, then the D skip and
    the gate, each operator rounded to xs's dtype."""
    f = torch.nn.functional
    dt = f.softplus(dt_raw.to(torch.float32) + dt_bias)
    y32, state = ops.mamba_scan(xs.to(torch.float32), dt, Bs.to(torch.float32),
                                Cs.to(torch.float32), A)
    return (y32.to(xs.dtype) + xs * D) * f.silu(z), state


def _mixer_tensors(B, T, di, n, W, dtype, seed):
    """xz (B,T,2di) and bc (B,T,2n) as the mixer has them, their halves read
    as strided views; the rest as ``tests/test_torch_cuda.py`` draws them."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    xz, bc = randn(B, T, 2 * di).to(dtype), (0.5 * randn(B, T, 2 * n)).to(dtype)
    w, tail = (0.5 * randn(W, di)).to(dtype), randn(B, W - 1, di).to(dtype)
    dt_raw = randn(B, T, di)
    dt_raw[..., ::7] += 25.0                       # past softplus's threshold of 20
    A, dt_bias = -torch.exp(0.3 * randn(di, n)), -1.5 + 0.1 * randn(di)
    return xz, bc, w, tail, dt_raw.to(dtype), A, dt_bias, randn(di).to(dtype)


def _fp32(*ts):
    return [t.to(torch.float32) if t.is_floating_point() else t for t in ts]


# T = 1, T < W-1, T off the 32-step chunk (and the 8-step conv chunk);
# d_inner off a multiple of 4 and of 8; each of STATE_SIZES; W 2 to 4.
MIXER_CASES = [(1, 1, 16, 4, 4), (2, 2, 12, 8, 4), (2, 37, 10, 16, 3), (3, 45, 24, 32, 4),
               (1, 70, 9, 4, 2), (2, 33, 20, 8, 4)]


@pytest.mark.parametrize("B,T,di,n,W", MIXER_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_plain_equals_the_operator_chain(B, T, di, n, W, dtype, with_tail):
    """The conv kernel's plain twin against the chain it replaces, on xz's
    first half as a strided view: bit for bit in fp32; in bf16 within bf16
    rounding, and at least as near the chain in fp32 (one rounding, not
    one an operator); the new tail exact."""
    xz, _, w, tail, *_ = _mixer_tensors(B, T, di, n, W, TORCH[dtype], seed=T + di)
    tail = tail if with_tail else None
    x = xz[..., :di]
    assert x.stride() == (T * 2 * di, 2 * di, 1)
    y, new_tail = ops.causal_conv_silu(x, w, tail)
    want, want_tail = _conv_chain(x, w, tail)
    assert y.dtype == x.dtype and new_tail.shape == (B, W - 1, di)
    assert torch.equal(new_tail, want_tail)
    if dtype == "float32":
        assert torch.equal(y, want)
        return
    torch.testing.assert_close(y, want, **TOL[dtype])
    exact, _ = _conv_chain(*_fp32(x, w), None if tail is None else tail.float())
    assert (y.float() - exact).abs().max() <= (want.float() - exact).abs().max()


@pytest.mark.parametrize("B,T,di,n,W", MIXER_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_gated_plain_equals_the_operator_chain(B, T, di, n, W, dtype):
    """The gated scan's plain twin against the chain it replaces, on bc's
    halves and xz's second half as strided views: bit for bit in fp32; in
    bf16 within bf16 rounding and at least as near the chain in fp32; the
    final state bit for bit (the same fp32 scan)."""
    xz, bc, _, _, dt_raw, A, dt_bias, D = _mixer_tensors(B, T, di, n, W, TORCH[dtype], seed=T)
    xs = torch.nn.functional.silu(xz[..., :di].float()).to(TORCH[dtype])
    args = (xs, dt_raw, bc[..., :n], bc[..., n:], A, dt_bias, D, xz[..., di:])
    assert [t.stride(1) for t in (args[2], args[3], args[7])] == [2 * n, 2 * n, 2 * di]
    y, state = ops.mamba_scan_gated(*args)
    want, want_state = _gated_chain(*args)
    assert y.dtype == xs.dtype and y.shape == (B, T, di)
    assert torch.equal(state, want_state)
    if dtype == "float32":
        assert torch.equal(y, want)
        return
    torch.testing.assert_close(y, want, **TOL[dtype])
    exact, _ = _gated_chain(*_fp32(*args))
    assert (y.float() - exact).abs().max() <= (want.float() - exact).abs().max()
    assert ops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_mixer_kernel_route_equals_the_plain_route(dtype):
    """``mamba_mixer(use_kernel=True)`` (the conv and gated scan's plain
    twins here) against ``use_kernel=False`` on hymba's tiny config: the
    output and final state within 1e-4 of their largest |entry| in fp32
    (the two scans sum in other orders), the conv tail exact. In bf16 each
    route is held to the fp32 mixer on the same input: the kernel route,
    rounded once, no farther from it than the plain route, which rounds
    every operator (on these random weights the output reaches 3e5)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build as build_model
    from repro_torch.models.hymba import mamba_mixer

    def mixer(dt, **kw):
        cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), dtype=dt)
        params = build_model(cfg).init(torch.Generator().manual_seed(11), device="cpu")
        p = {k: v[0] for k, v in params["layers"]["mamba"].items()}
        x = torch.randn((2, 45, cfg.d_model), generator=torch.Generator().manual_seed(12))
        return mamba_mixer(p, x.to(TORCH[dtype]).to(TORCH[dt]), cfg, **kw)

    def gap(a, b):
        return float((a.float() - b.float()).abs().max())

    out_k, state_k, conv_k = mixer(dtype, use_kernel=True)
    out_p, state_p, conv_p = mixer(dtype)
    assert out_k.dtype == out_p.dtype == TORCH[dtype]
    assert torch.equal(conv_k, conv_p)
    if dtype == "float32":
        assert gap(out_k, out_p) <= 1e-4 * float(out_p.abs().max())
        assert gap(state_k, state_p) <= 1e-4 * float(state_p.abs().max())
    else:
        out_32, state_32, _ = mixer("float32")
        assert gap(out_k, out_32) <= gap(out_p, out_32) <= 2e-2 * float(out_32.abs().max())
        assert gap(state_k, state_32) <= 2e-2 * float(state_32.abs().max())
    assert ops.launch_counts() == NO_LAUNCHES


def test_mixer_kernel_entries_refuse_autograd_and_other_devices():
    """Off the CPU, the conv and gated scan entries raise before their
    wrappers when an input requires grad, and their wrappers raise on a
    tensor not on CUDA; nothing launches."""
    def meta(*shape, grad=True):
        return torch.empty(shape, device="meta", requires_grad=grad)

    x, w = meta(1, 8, 4), meta(4, 4)
    gated = (x, x, meta(1, 8, 4), meta(1, 8, 4), meta(4, 4), meta(4), meta(4), x)
    with pytest.raises(RuntimeError, match="causal_conv: the CUDA kernel has no backward"):
        ops.causal_conv_silu(x, w)
    with pytest.raises(RuntimeError, match="mamba_scan: the CUDA kernel has no backward"):
        ops.mamba_scan_gated(*gated)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.causal_conv_silu(x, w)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.mamba_scan_gated(*gated)
    cpu = torch.ones(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cc_mod.causal_conv_silu_cuda(cpu, torch.ones(4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ms_mod.mamba_scan_gated_cuda(cpu, cpu, cpu, cpu, torch.ones(4, 4), torch.ones(4),
                                     torch.ones(4), cpu)
    assert ops.launch_counts() == NO_LAUNCHES


def test_launch_counts_name_the_conv_kernel():
    """The conv kernel keeps its own counter beside the scan's."""
    assert "causal_conv" in ops.KERNELS and set(ops.launch_counts()) == set(NO_LAUNCHES)
    from repro_torch import tracing

    tracing.count("kernel.causal_conv.launches", 3)
    assert ops.launch_counts()["causal_conv"] == 3
    ops.reset_launch_counts()
    assert ops.launch_counts() == NO_LAUNCHES


def test_flash_bf16_wrapper_copies_only_what_the_kernel_cannot_read():
    """The bf16 kernel's 16-byte rows: the wrapper keeps an aligned operand
    (the model layout, and a head slice of it) as it is, and copies one
    whose data pointer or seq stride is not 16-byte aligned, into an
    aligned tensor with the same values."""
    x = torch.randn(2, 40, 3, 64).to(torch.bfloat16)
    assert fa_mod.kernel_ready(x) and fa_mod.kernel_operand(x) is x
    heads = x[:, :, 1:]                              # offset of one head: 64 elements
    assert fa_mod.kernel_ready(heads) and fa_mod.kernel_operand(heads) is heads
    moved = torch.randn(2 * 40 * 3 * 64 + 4).to(torch.bfloat16)[4:].view(2, 40, 3, 64)
    padded = torch.randn(2, 40, 3 * 64 + 4).to(torch.bfloat16)[..., :192].unflatten(-1, (3, 64))
    half = torch.randn(2, 40, 3, 72).to(torch.bfloat16)[..., :64]   # fine: strides of 8
    for y, ready in ((moved, False), (padded, False), (half, True),
                     (x.transpose(1, 2), True), (x[..., ::2], False)):
        assert fa_mod.kernel_ready(y) is ready
        out = fa_mod.kernel_operand(y)
        assert (out is y) is ready
        assert fa_mod.kernel_ready(out) and torch.equal(out, y)
    assert moved.is_contiguous() and moved.data_ptr() % 16 == 8


def test_flash_fp32_wrapper_copies_only_what_the_kernel_cannot_read():
    """The fp32 kernel's 16-byte cp.async rows: strides of 4 elements and a
    16-byte aligned pointer are read in place (the transposed layout of
    tests/test_torch_cuda.py's strided case too); a pointer 2 elements in,
    a seq stride of 2 mod 4, or a strided last dim are copied."""
    x = torch.randn(2, 40, 3, 64)
    assert fa_mod.kernel_ready(x) and fa_mod.kernel_operand(x) is x
    moved = torch.randn(2 * 40 * 3 * 64 + 2)[2:].view(2, 40, 3, 64)
    padded = torch.randn(2, 40, 3 * 64 + 2)[..., :192].unflatten(-1, (3, 64))
    quarter = torch.randn(2, 40, 3, 68)[..., :64]    # fine: strides of 4
    for y, ready in ((moved, False), (padded, False), (quarter, True),
                     (torch.randn(2, 3, 40, 64).transpose(1, 2), True),
                     (x[..., ::2], False), (x[:, :, 1:], True)):
        assert fa_mod.kernel_ready(y) is ready
        out = fa_mod.kernel_operand(y)
        assert (out is y) is ready
        assert fa_mod.kernel_ready(out) and torch.equal(out, y)
    assert moved.data_ptr() % 16 == 8


def test_lm_kernel_wrappers_refuse_non_cuda_tensors():
    q = torch.ones(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    xs, Bs, A = torch.ones(1, 4, 8), torch.ones(1, 4, 4), torch.ones(8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ms_mod.mamba_scan_cuda(xs, xs, Bs, Bs, A)
    with pytest.raises(ValueError, match="CUDA"):
        ops.mamba_scan(*(x.to("meta") for x in (xs, xs, Bs, Bs, A)))
    assert ops.launch_counts() == NO_LAUNCHES


# --------------------------------------------------------------------- wkv6
def _wkv6_inputs(lead, n, seed=50, w_scale=0.5, w_shift=0.4):
    """Drawn as tests/test_kernels.py::test_wkv6_shapes draws them: r, k, v
    at 0.5, w = sigmoid(.)*0.5+0.4, u at 0.1; ``lead`` is (BH, T) or
    (B, T, H)."""
    rng = np.random.default_rng(seed)
    r, k, v = ((0.5 * rng.normal(size=(*lead, n))).astype(np.float32)
               for _ in range(3))
    w = (w_scale / (1 + np.exp(-rng.normal(size=(*lead, n)))) + w_shift
         ).astype(np.float32)
    return r, k, v, w


@pytest.mark.parametrize("t,n,bt", [(64, 16, 32), (128, 32, 64), (128, 64, 128)])
def test_plain_wkv6_matches_pallas(t, n, bt):
    """The shapes of tests/test_kernels.py::test_wkv6_shapes."""
    from repro.kernels.wkv6 import wkv6_pallas

    BH = 3
    r, k, v, w = _wkv6_inputs((BH, t), n)
    u = (0.1 * np.random.default_rng(51).normal(size=(BH, n))).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    y_p, s_p = wkv6_pallas(*jargs, bt=bt, interpret=True)
    y_r, s_r = jref.wkv6(*jargs)
    y, s = ref.wkv6(*map(torch.from_numpy, (r, k, v, w, u)))
    assert y.shape == (BH, t, n) and s.shape == (BH, n, n) and s.dtype == torch.float32
    for out, expect in ((y, y_p), (s, s_p), (y, y_r), (s, s_r)):
        _close(out, expect, "float32")


@pytest.mark.parametrize("B,S,H,N", [(2, 64, 3, 16), (1, 128, 2, 64)])
def test_ops_wkv6_matches_jax_ops(B, S, H, N):
    """The model-layout wrapper ((B,S,H,N) <-> (BH,S,N), u broadcast over
    the batch) against repro.kernels.ops.wkv6 (Pallas in interpret mode)."""
    from repro.kernels import ops as jops

    r, k, v, w = _wkv6_inputs((B, S, H), N, seed=52)
    u = (0.1 * np.random.default_rng(53).normal(size=(H, N))).astype(np.float32)
    y_j, s_j = jops.wkv6(*map(jnp.asarray, (r, k, v, w, u)))
    y, s = ops.wkv6(*map(torch.from_numpy, (r, k, v, w, u)))
    assert y.shape == (B, S, H, N) and s.shape == (B, H, N, N)
    _close(y, y_j, "float32")
    _close(s, s_j, "float32")
    assert ops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("T", [1, 37, 100])
def test_ops_wkv6_any_length_matches_jax_ref(T):
    """Prompts are not multiples of the Pallas chunk: any T, against the
    JAX package's sequential oracle."""
    B, H, N = 2, 2, 32
    r, k, v, w = _wkv6_inputs((B, T, H), N, seed=54)
    u = (0.1 * np.random.default_rng(55).normal(size=(H, N))).astype(np.float32)
    y, s = ops.wkv6(*map(torch.from_numpy, (r, k, v, w, u)))

    def flat(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, T, N))

    y_r, s_r = jref.wkv6(flat(r), flat(k), flat(v), flat(w),
                         jnp.asarray(np.broadcast_to(u, (B, H, N)).reshape(B * H, N)))
    _close(y.transpose(1, 2).reshape(B * H, T, N), y_r, "float32")
    _close(s.reshape(B * H, N, N), s_r, "float32")


def test_ops_wkv6_matches_model_scan():
    """The wrapper against the model's scan from a zero state, at the
    shapes and 2e-5 of tests/test_kernels.py::test_wkv6_matches_model_layer."""
    from repro.models.rwkv6 import wkv6_scan as jax_scan
    from repro_torch.models.rwkv6 import wkv6_scan

    B, S, H, N = 1, 48, 2, 16
    r, k, v, w = _wkv6_inputs((B, S, H), N, seed=56, w_scale=0.4, w_shift=0.5)
    u = (0.1 * np.random.default_rng(57).normal(size=(H, N))).astype(np.float32)
    targs = list(map(torch.from_numpy, (r, k, v, w, u)))
    y, s = ops.wkv6(*targs)
    y_s, s_s = wkv6_scan(*targs, torch.zeros((B, H, N, N)))
    y_j, s_j = jax_scan(*map(jnp.asarray, (r, k, v, w, u)),
                        jnp.zeros((B, H, N, N), jnp.float32))
    tol = dict(rtol=2e-5, atol=2e-5)
    for out, expect in ((y, y_s), (s, s_s), (y, y_j), (s, s_j)):
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), **tol)


def test_wkv6_wrapper_refuses_what_the_kernel_does_not_take():
    """CPU tensors, other dtypes, head sizes outside 16/32/64 and misfit
    shapes are refused before anything launches; ops.wkv6 has no state
    argument to drop."""
    x, u = torch.ones(1, 4, 2, 16), torch.ones(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_mod.wkv6_cuda(x, x, x, x, u)
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv6(*(t.to("meta") for t in (x, x, x, x, u)))
    with pytest.raises(ValueError, match="float32"):
        wkv_mod.wkv6_cuda(x.double(), x, x, x, u)
    with pytest.raises(ValueError, match="float32"):
        wkv_mod.wkv6_cuda(x, x, x, x.bfloat16(), u)
    for n in (8, 48, 128):
        xn, un = torch.ones(1, 4, 2, n), torch.ones(2, n)
        with pytest.raises(ValueError, match="head size"):
            wkv_mod.wkv6_cuda(xn, xn, xn, xn, un)
    with pytest.raises(ValueError, match="do not fit"):
        wkv_mod.wkv6_cuda(x, x, x, x, torch.ones(3, 16))
    with pytest.raises(ValueError, match="do not fit"):
        wkv_mod.wkv6_cuda(x, x[:, :3], x, x, u)
    with pytest.raises(TypeError):
        ops.wkv6(x, x, x, x, u, torch.zeros(1, 2, 16, 16))
    assert ops.launch_counts() == NO_LAUNCHES
