"""The port's loop-aware count of reduced cells against the JAX package's.

The reference counts the HLO of its compiled function
(``hlo_cost.analyze``: 2 x out_elems x contraction of every dot, while
bodies times their trip count); the port counts the same function's
products on the meta device (``repro_torch.launch.flops``), its Python
loops folded. Both sides build the reduced config of one arch at the
same shapes.

Tolerances: relative 1e-6 wherever the counts agree. Two train cells do
not, and the gap is one named operation: the backward of the per-step
contraction in the plain scans (Hymba's ``bdn,bn->bd``, RWKV-6's
``bhi,bhij->bhj``) forms an outer product, a product with a contraction
of length 1. PyTorch's autograd runs it as a ``bmm`` (counted, 2 m n),
XLA rewrites it into a broadcast multiply (not a dot, not counted). So
the port counts 2 B d n more a step and layer for Hymba (0.2755%) and
2 B H N N for RWKV-6 (1.5873%): tolerances 0.5% and 2.0%, the gaps
rounded up to the next 0.5%.
"""
import dataclasses

import jax
import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.launch import hlo_cost
from repro.launch import specs as jspecs
from repro.models import build as jax_build
from repro.models.config import ShapeConfig as JShape
from repro_torch.configs import get_config
from repro_torch.launch import flops, knobs, specs, steps
from repro_torch.models import build
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.params import abstract_params
from repro_torch.training.loop import value_and_grad

EXACT = 1e-6
SCAN_BACKWARD_GAP = {"hymba-1.5b": 5e-3, "rwkv6-3b": 2e-2}
SERVED = ["smollm-135m", "qwen2-moe-a2.7b", "hymba-1.5b", "rwkv6-3b"]
B, S = 2, 64


def _jax_flops(kind: str, arch: str, batch: int, seq: int) -> float:
    cfg = jax_config(arch).reduced()
    model = jax_build(cfg)
    if kind == "train":
        b = jspecs.batch_specs(cfg, JShape("t", seq, batch, "train"))
        fn = lambda p, b: jax.value_and_grad(lambda q: model.loss(q, b))(p)  # noqa: E731
        args = (model.abstract(), b)
    elif kind == "prefill":
        x = jspecs.prefill_specs(cfg, JShape("p", seq, batch, "prefill"))["inputs"]
        fn = lambda p, x: model.last_logits(p, x)  # noqa: E731
        args = (model.abstract(), x)
    else:
        d = jspecs.decode_specs(cfg, JShape("d", seq, batch, "decode"))
        fn = lambda p, c, pos, t: model.decode_step(p, c, pos, t)  # noqa: E731
        args = (model.abstract(), d["cache"], d["pos"], d["token"])
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _cell(kind: str, arch: str, batch: int, seq: int):
    """The port's function of the same cell and its meta arguments."""
    cfg = get_config(arch).reduced()
    model = build(cfg)
    params = abstract_params(model.schema)
    if kind == "train":
        b = specs.batch_specs(cfg, ShapeConfig("t", seq, batch, "train"))
        return (lambda p, b: value_and_grad(lambda q: model.loss(q, b), p)), (params, b)
    if kind == "prefill":
        x = specs.prefill_specs(cfg, ShapeConfig("p", seq, batch, "prefill"))["inputs"]
        return steps.make_prefill_step(model, use_kernel=False), (params, x)
    d = specs.decode_specs(cfg, ShapeConfig("d", seq, batch, "decode"))
    return steps.make_serve_step(model), (params, d["cache"], seq - 1, d["token"])


def _torch_flops(kind: str, arch: str, batch: int, seq: int) -> float:
    fn, args = _cell(kind, arch, batch, seq)
    return flops.count(fn, *args).flops


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradient_flops_match_hlo_cost(arch):
    mine, ref = _torch_flops("train", arch, B, S), _jax_flops("train", arch, B, S)
    assert mine == pytest.approx(ref, rel=SCAN_BACKWARD_GAP.get(arch, EXACT))
    if arch in SCAN_BACKWARD_GAP:
        assert mine > ref     # the counted outer products, never fewer


def test_the_scan_backward_gap_is_the_outer_products():
    """The whole gap, exactly: one outer product a step and layer."""
    for arch in SCAN_BACKWARD_GAP:
        cfg = get_config(arch).reduced()
        if arch == "hymba-1.5b":
            per_step = 2 * B * cfg.d_inner * cfg.ssm_state
        else:
            per_step = 2 * B * cfg.d_model * 64     # H heads of N = 64: 2 B H N N
        gap = _torch_flops("train", arch, B, S) - _jax_flops("train", arch, B, S)
        assert gap == per_step * S * cfg.n_layers


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_flops_match_hlo_cost(arch, kind):
    mine, ref = _torch_flops(kind, arch, B, S), _jax_flops(kind, arch, B, S)
    assert mine == pytest.approx(ref, rel=EXACT)


def test_chunk_skip_difference_at_4096_is_exact():
    """Above CHUNK_THRESHOLD (four 1024-token chunks) the reference scans
    every key chunk for every query chunk (16 pairs a layer), the port
    the 10 that reach a query's causal window: 6 pairs' two products
    fewer a layer."""
    cfg = get_config("smollm-135m").reduced()
    H, hd, batch, seq = cfg.n_heads, cfg.resolved_head_dim, 1, 4096
    skipped = 6 * 4 * batch * H * 1024 * 1024 * hd * cfg.n_layers
    mine, ref = (_torch_flops("prefill", "smollm-135m", batch, seq),
                 _jax_flops("prefill", "smollm-135m", batch, seq))
    assert mine == ref - skipped


def _cells():
    for arch in ARCH_IDS:
        for kind in ("train", "prefill", "decode"):
            yield arch, kind


@pytest.mark.parametrize("arch,kind", list(_cells()))
def test_loop_aware_count_equals_the_unrolled_count(arch, kind):
    fn, args = _cell(kind, arch, B, S)
    folded, unrolled = (flops.count(fn, *args, loop_aware=a) for a in (True, False))
    assert folded.flops == unrolled.flops
    if kind != "train":
        # Forward only; a backward's gradient sums depend on the order the
        # trips' gradients arrive in, so its unfused bytes are not held.
        assert folded.bytes_unfused == unrolled.bytes_unfused


@pytest.mark.parametrize("arch,wkv_impl,seq", [
    ("smollm-135m", "scan", 4096), ("hymba-1.5b", "scan", 128), ("rwkv6-3b", "scan", 128),
    ("rwkv6-3b", "chunked", 128)])
def test_accumulated_train_step_folds_exactly(arch, wkv_impl, seq):
    """The train step with 4 microbatches: the microbatch loop (whose
    backward runs inside its trip) and, nested in it, the chunked
    attention's pairs at S = 4096 or the time or chunk loops."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=1)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq, global_batch=8)
    with knobs.apply(knobs.Knobs(microbatch=4, wkv_impl=wkv_impl)):
        step, args = flops.step_args(cfg, shape)
        folded = flops.count(step, *args).flops
        step, args = flops.step_args(cfg, shape)
        assert folded == flops.count(step, *args, loop_aware=False).flops


def test_flops_vs_analytic_model_flops():
    """Loss and gradient of a tiny LM within 0.3x-3x of 8 N D (fwd 2 +
    bwd 4 + remat 2), as the reference's own check."""
    model = build(get_config("smollm-135m").reduced())
    analytic = 8.0 * model.n_params * B * S
    count = _torch_flops("train", "smollm-135m", B, S)
    assert 0.3 * analytic < count < 3.0 * analytic


def test_count_cell_at_full_width_on_meta():
    """A full-width cell counts on the meta device without allocating:
    smollm-135m x decode_32k at the shape's global batch of 128 (a 96.6 GB
    cache)."""
    costs = flops.count_cell(get_config("smollm-135m"), SHAPES["decode_32k"])
    assert costs.flops > 0 and costs.argument_bytes > 96e9
