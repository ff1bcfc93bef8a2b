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
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import stencil as st_mod

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


@pytest.mark.parametrize("shape", [(1, 128, 128, 128), (3, 1000, 777, 513),
                                   (2, 1, 5, 3), (4, 256, 2048, 64)])
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
