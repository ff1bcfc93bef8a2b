"""The hand-written CUDA kernels on the card (skipped without one).

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs,
at the JAX package's kernel tolerances (fp32 1e-4, bf16 2e-2).
"""
import pytest
import torch

from repro_torch import apps
from repro_torch.apps import validate
from repro_torch.kernels import ops, ref
from repro_torch.kernels import matmul as mm_mod
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
