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
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import stencil as st_mod

# The fp32 and bf16 tolerances of tests/test_kernels.py (blocked-vs-flat
# accumulation order at k ~ 512; bf16 rounding).
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NO_LAUNCHES = {"matmul": 0, "stencil": 0, "segment_rowmax": 0}


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


def test_plain_matmul_keeps_fp32_out_of_tf32():
    ref.matmul(torch.ones(2, 2), torch.ones(2, 2))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
