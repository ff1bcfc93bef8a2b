"""The port's GPipe pipeline on virtual ranks against the JAX package's on
8 fake devices.

The toy residual MLP of ``tests/test_pipeline.py`` (L=8, D=16, M=4
microbatches of Bm=2) under a ``(pod=2, data=4)`` mesh. The JAX side runs
once, in a child process with ``--xla_force_host_platform_device_count=8``,
and hands back its weights, inputs, pipelined and sequential outputs and
gradients through an ``.npz`` file. Forward within 1e-5 and gradient
within 1e-4 of both, with the ``ppermute`` ticks counted (T = M + S - 1).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import spmd
from repro_torch.training.pipeline import bubble_fraction, pipelined_apply, split_stages

REPO = Path(__file__).resolve().parent.parent
L, D, M, Bm = 8, 16, 4, 2

SNIPPET = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.training.pipeline import pipelined_apply, split_stages

L, D, M, Bm = 8, 16, 4, 2
W = 0.3 * jax.random.normal(jax.random.key(0), (L, D, D), jnp.float32)
x = jax.random.normal(jax.random.key(1), (M, Bm, D), jnp.float32)

def layer_fn(w, x):
    return x + jnp.tanh(x @ w)

def seq_apply(W, x_all):
    def body(h, w):
        return layer_fn(w, h), None
    out, _ = jax.lax.scan(body, x_all.reshape(M * Bm, D), W)
    return out.reshape(M, Bm, D)

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("pod", "data"))
apply = pipelined_apply(lambda p, h: layer_fn(p["w"], h), mesh, n_microbatches=M)
pipe = lambda W_, x: apply(split_stages({"w": W_}, 2), x)
g_pipe = jax.grad(lambda W_: jnp.sum(pipe(W_, x) ** 2))(W)
g_seq = jax.grad(lambda W_: jnp.sum(seq_apply(W_, x) ** 2))(W)
np.savez(sys.argv[1], W=W, x=x, pipe=jax.jit(pipe)(W, x), seq=seq_apply(W, x),
         g_pipe=g_pipe, g_seq=g_seq)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(REPO / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, "-c", SNIPPET, str(path)],
                          capture_output=True, text=True, timeout=420, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _layer(p, h):
    return h + torch.tanh(h @ p["w"])


def _mesh(shape=(2, 4), names=("pod", "data")):
    return spmd.Mesh(np.arange(int(np.prod(shape))).reshape(shape), names, "cpu")


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2,)])
def test_pipelined_apply_matches_jax(ref, mesh_shape):
    """Forward and the gradient of sum(y**2) against the reference's
    pipelined and sequential values; (2,) runs the stages alone, (2, 4)
    with four data replicas of each."""
    mesh = _mesh(mesh_shape, ("pod", "data")[:len(mesh_shape)])
    W = torch.from_numpy(ref["W"]).requires_grad_(True)
    x = torch.from_numpy(ref["x"])
    apply = pipelined_apply(_layer, mesh, n_microbatches=M)
    spmd.reset_counts()
    y = apply(split_stages({"w": W}, 2), x)
    assert spmd.counts()["ppermute"] == M + 2 - 1          # one a tick
    assert spmd.counts()["shard_map"] == 1
    (g,) = torch.autograd.grad((y ** 2).sum(), W)
    for key in ("pipe", "seq"):
        np.testing.assert_allclose(y.detach().numpy(), ref[key], rtol=1e-5, atol=1e-5)
    for key in ("g_pipe", "g_seq"):
        np.testing.assert_allclose(g.numpy(), ref[key], rtol=1e-4, atol=1e-4)


def test_pipeline_on_four_stages_matches_the_sequential_stack(ref):
    """Four stages of two layers on a (pod=4,) mesh: T = 7 ticks."""
    mesh = _mesh((4,), ("pod",))
    W = torch.from_numpy(ref["W"]).requires_grad_(True)
    spmd.reset_counts()
    y = pipelined_apply(_layer, mesh, n_microbatches=M)(
        split_stages({"w": W}, 4), torch.from_numpy(ref["x"]))
    assert spmd.counts()["ppermute"] == M + 4 - 1
    np.testing.assert_allclose(y.detach().numpy(), ref["seq"], rtol=1e-5, atol=1e-5)
    (g,) = torch.autograd.grad((y ** 2).sum(), W)
    np.testing.assert_allclose(g.numpy(), ref["g_seq"], rtol=1e-4, atol=1e-4)


def test_split_stages_and_bubble():
    stages = split_stages({"w": torch.zeros(8, 3, 5), "b": torch.zeros(8, 5)}, 2)
    assert tuple(stages["w"].shape) == (2, 4, 3, 5)
    assert tuple(stages["b"].shape) == (2, 4, 5)
    with pytest.raises(AssertionError):
        split_stages({"w": torch.zeros(6, 3)}, 4)
    assert bubble_fraction(2, 4) == 1 / 5
    assert bubble_fraction(4, 4) == 3 / 7
