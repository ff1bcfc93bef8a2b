"""The port's ``models/sharding.py`` against the JAX package's, and the
bf16 route's coverage.

``bf16_gather`` acts in the reference without a mesh: ``layer_barrier``
casts each layer's fp32 weights of two or more dims to bf16 at layer
entry in every forward loop. The port's last logits and loss under
``Knobs(bf16_gather=True)`` are held to the reference's under the same
knob (measured: 8.6e-7 on the logits, 2.4e-6 on the loss, against
5.2e-3 to 7.9e-3 between the knob on and off), three families, reduced
fp32, B=2, S=32. The dense bf16 route (``dtype="bfloat16"``) is held to
the reference's on shared weights, B=2, S=64, within the bound the port
has measured against it (4.5e-2 at |logit| <= 0.74; this test's inputs
give 3.9e-3 to 2.9e-2). deepseek-v2-lite-16b is left out of that one: in
bf16 its routing flips at near-ties and moves a few positions by 1.7e-1,
while with every layer dense it agrees within 1.6e-2.
"""
import dataclasses
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import knobs as jknobs
from repro.models import build as jax_build
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import spmd
from repro_torch.launch import knobs, policy, steps
from repro_torch.models import build, params_from_numpy
from repro_torch.models import sharding as shd
from repro_torch.models.config import SHAPES

FWD = dict(rtol=1e-4, atol=1e-4)
BF16_LOGITS_ATOL = 4.5e-2
GATHER_ARCHS = ["smollm-135m", "hymba-1.5b", "rwkv6-3b"]
BF16_ARCHS = [a for a in ARCH_IDS if a != "deepseek-v2-lite-16b"]


def _pair(arch, dtype):
    """(JAX model, JAX params, port model, port params), reduced, on the
    same weights."""
    jm = jax_build(dataclasses.replace(jax_config(arch).reduced(), dtype=dtype))
    tm = build(dataclasses.replace(get_config(arch).reduced(), dtype=dtype))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jm, jax.tree.map(jnp.asarray, tree), tm, params_from_numpy(tree, "cpu")


def _inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.stub_frontend:
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x)
    ids = rng.integers(0, cfg.vocab_size, size=(B, S))
    return jnp.asarray(ids, jnp.int32), torch.from_numpy(ids).long()


# ------------------------------------------------------------ bf16_gather
@pytest.mark.parametrize("arch", GATHER_ARCHS)
def test_bf16_gather_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch, "float32")
    ji, ti = _inputs(tm.cfg, 2, 32)
    labels = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, size=(2, 32))
    with jknobs.apply(jknobs.Knobs(bf16_gather=True)):
        jlast = np.asarray(jm.last_logits(jp, ji))
        jloss = float(jm.loss(jp, {"inputs": ji, "labels": jnp.asarray(labels, jnp.int32)}))
    with knobs.apply(knobs.Knobs(bf16_gather=True)), torch.no_grad():
        last = tm.last_logits(tp, ti)
        loss = float(tm.loss(tp, {"inputs": ti, "labels": torch.from_numpy(labels)}))
    np.testing.assert_allclose(last.numpy(), jlast, **FWD)
    assert abs(loss - jloss) <= FWD["atol"], (loss, jloss)
    with torch.no_grad():
        plain = tm.last_logits(tp, ti)                # knob off: fp32 weights
    assert float((plain - last).abs().max()) > 1e-3     # the cast acts


def test_layer_barrier_casts_matrices_and_keeps_gradients_fp32():
    w = torch.randn(3, 4, requires_grad=True)
    tree = {"w": w, "scale": torch.ones(4), "idx": torch.zeros(2, 2, dtype=torch.int32)}
    assert shd.layer_barrier(tree) is tree                    # knob off
    with knobs.apply(knobs.Knobs(bf16_gather=True)):
        out = shd.layer_barrier(tree)
    assert out["w"].dtype == torch.bfloat16
    assert out["scale"].dtype == torch.float32 and out["idx"].dtype == torch.int32
    (g,) = torch.autograd.grad(out["w"].float().sum(), w)
    assert g.dtype == torch.float32 and torch.equal(g, torch.ones(3, 4))


# ------------------------------------------------------------- bf16 route
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_last_logits_match_jax(arch):
    jm, jp, tm, tp = _pair(arch, "bfloat16")
    ji, ti = _inputs(tm.cfg, 2, 64)
    jlast = np.asarray(jm.last_logits(jp, ji).astype(jnp.float32))
    with torch.no_grad():
        last = tm.last_logits(tp, ti)
    assert last.dtype == torch.bfloat16
    np.testing.assert_allclose(last.float().numpy(), jlast, rtol=0, atol=BF16_LOGITS_ATOL)


# ------------------------------------------------------------ constraints
def test_constrain_checks_the_spec_and_returns_x():
    x = torch.zeros(4, 8, 6)
    assert shd.residual(x) is x and shd.logits_sharded(x) is x      # no mesh
    mesh = spmd.Mesh(np.arange(8).reshape(2, 4), ("data", "model"), "cpu")
    with spmd.use_mesh(mesh):
        assert shd._mesh_axis_names() == ("data", "model")
        assert shd.constrain(x, ("pod", "data"), "model") is x
        assert shd.constrain(x, None, None, "model") is x      # 6 % 4: unsharded
        assert shd.batch_sharded(x) is x and shd.logits_sharded(x) is x
        with pytest.raises(ValueError):
            shd.constrain(x, "model", "model")
    assert shd._filter(("pod", "data"), ("data", "model")) == ("data",)
    assert shd._filter("pod", ("data", "model")) is None


@pytest.mark.parametrize("shape_name,seq", [("train_4k", "model"), ("prefill_32k", "model"),
                                            ("decode_32k", None)])
def test_mesh_settings_are_make_cells(shape_name, seq):
    cfg, shape = get_config("smollm-135m"), SHAPES[shape_name]
    mesh = spmd.Mesh(np.arange(8).reshape(2, 4), ("data", "model"), "cpu")
    with steps.mesh_settings(cfg, shape, mesh) as mode:
        assert mode == policy.choose_mode(cfg) == "fsdp"
        assert shd.seq_axis() == seq and shd._LAYER_BARRIER
        tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
        assert shd.moe_groups() == math.gcd(2, tokens)
        assert spmd.current_mesh() is mesh
    assert shd.seq_axis() is None and not shd._LAYER_BARRIER and shd.moe_groups() == 1
    assert spmd.current_mesh() is None
    with steps.mesh_settings(get_config("qwen2-moe-a2.7b"), shape, None) as mode:
        assert mode == "tp" and not shd._LAYER_BARRIER
        assert shd.seq_axis() == seq and shd.moe_groups() == 1


# ------------------------------------------------------------ checkpoints
def test_restore_under_a_plans_shardings():
    """A checkpoint written once restores onto a mesh's device under a
    plan's shardings (the elastic restore of
    ``tests/test_system.py::test_elastic_restore_under_new_sharding``)."""
    tree = {"w": torch.arange(32.0).reshape(8, 4), "b": torch.arange(4.0)}
    mesh = spmd.Mesh(np.arange(8).reshape(2, 4), ("data", "model"), "meta")
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, tree)
        mgr.wait()
        sh = {"w": policy.shard(mesh, spmd.P("data", "model")), "b": policy.shard(mesh, spmd.P())}
        step, restored, _ = mgr.restore(shardings=sh)
        assert step == 1 and restored["w"].device.type == "meta"
        assert tuple(restored["w"].shape) == (8, 4)
        _, on_cpu, _ = mgr.restore(shardings={"b": sh["b"]}, device="cpu")
        assert torch.equal(on_cpu["w"], tree["w"]) and on_cpu["b"].device.type == "meta"
        with pytest.raises(ValueError):                  # 4 entries over 8 ranks
            mgr.restore(shardings={"b": policy.shard(mesh, spmd.P(("data", "model")))})
