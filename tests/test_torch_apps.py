"""The slice as a whole: the nine apps in the port against the JAX package.

One child process (8 fake CPU devices, as ``tests/test_distributed.py``
runs its meshes) executes the JAX package's ``ALGORITHMS[...].matmul``,
``stencil2d.run``, ``pennant.run`` and ``circuit.run`` at the sizes of
``repro/apps/validate.py``, on inputs made here with numpy. The port runs
the same inputs on the CPU, carried over by ``state_from_numpy``, with the
matmul bodies on the kernel path (``use_kernel=True``). Outputs agree
within the fp32 tolerance of ``tests/test_kernels.py``: the arithmetic is
the same, only the summation order differs (blocking, scatter-add).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.science import circuit as jcircuit
from repro_torch import apps
from repro_torch.apps.state import state_from_numpy
from repro_torch.matmul import ALGORITHMS
from repro_torch.matmul.common import MatmulGrid
from repro_torch.science import circuit, pennant, stencil2d

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
TOL = dict(rtol=1e-4, atol=1e-4)

JAX_SNIPPET = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro import apps
from repro.matmul import ALGORITHMS
from repro.matmul.common import MatmulGrid
from repro.science import circuit, pennant, stencil2d

inp = np.load(sys.argv[1])
out = {}
for app in apps.iter_apps():
    n = app.default_procs
    plan = app.spmd_plan(n, devices=jax.devices()[:n])
    grid = MatmulGrid(mesh=plan.mesh, axis_names=plan.axis_names)
    k = app.name
    if app.kind == "matmul":
        out[k] = ALGORITHMS[k].matmul(jnp.asarray(inp[k + ".a"]),
                                      jnp.asarray(inp[k + ".b"]), grid)
    elif k == "stencil":
        gx, gy = grid.shape
        cfg = stencil2d.StencilConfig(nx=16 * gx, ny=16 * gy, steps=2)
        out[k] = stencil2d.run(jnp.asarray(inp[k + ".field"]), grid, cfg)
    elif k == "pennant":
        gx, gy = grid.shape
        cfg = pennant.PennantConfig(nzx=16 * gx, nzy=16 * gy, steps=2)
        state = tuple(jnp.asarray(inp[k + "." + f]) for f in "rho e u v".split())
        for f, v in zip("rho e u v".split(), pennant.run(state, grid, cfg)):
            out[k + "." + f] = v
    elif k == "circuit":
        cfg = circuit.CircuitConfig(pieces=n, steps=2)
        fields = ("voltage", "charge", "capacitance", "src", "dst", "resistance")
        st = circuit.CircuitState(**{f: jnp.asarray(inp[k + "." + f]) for f in fields})
        out[k] = circuit.run(st, grid, cfg)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("jax apps OK", len(out))
"""


def _configs():
    """Per app: the validate-size config and its numpy inputs."""
    rng = np.random.default_rng(0)
    inputs, cfgs = {}, {}
    for app in apps.iter_apps():
        k, n = app.name, app.default_procs
        grid = app.tile_grid(n)
        if app.kind == apps.MATMUL:
            size = 32 * max(grid)
            inputs[k + ".a"] = rng.normal(size=(size, size)).astype(np.float32)
            inputs[k + ".b"] = rng.normal(size=(size, size)).astype(np.float32)
        elif k == "stencil":
            cfgs[k] = stencil2d.StencilConfig(nx=16 * grid[0], ny=16 * grid[1],
                                              steps=2)
            nx, ny = cfgs[k].nx, cfgs[k].ny
            inputs[k + ".field"] = (np.arange(nx * ny, dtype=np.float32)
                                    .reshape(nx, ny) / (nx * ny))
        elif k == "pennant":
            cfgs[k] = pennant.PennantConfig(nzx=16 * grid[0], nzy=16 * grid[1],
                                            steps=2)
            shape = (cfgs[k].nzx, cfgs[k].nzy)
            inputs[k + ".rho"] = (1.0 + 0.1 * rng.uniform(size=shape)).astype(np.float32)
            inputs[k + ".e"] = (1.0 + 0.1 * rng.uniform(size=shape)).astype(np.float32)
            inputs[k + ".u"] = np.zeros(shape, np.float32)
            inputs[k + ".v"] = np.zeros(shape, np.float32)
        elif k == "circuit":
            cfgs[k] = circuit.CircuitConfig(pieces=n, steps=2)
            st = jcircuit.generate(jcircuit.CircuitConfig(pieces=n, steps=2),
                                   seed=0)
            for f in ("voltage", "charge", "capacitance", "src", "dst",
                      "resistance"):
                inputs[k + "." + f] = np.asarray(getattr(st, f))
    return inputs, cfgs


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's nine apps on the shared inputs, in one child."""
    d = tmp_path_factory.mktemp("jax_apps")
    inputs, cfgs = _configs()
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SNIPPET, str(d / "inputs.npz"),
         str(d / "outputs.npz")],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return inputs, cfgs, dict(np.load(d / "outputs.npz"))


def _inputs_of(inputs, name):
    return {k.split(".", 1)[1]: v for k, v in inputs.items()
            if k.startswith(name + ".")}


@pytest.mark.parametrize("name", list(apps.PAPER_APPS))
def test_port_matches_jax_package(jax_run, name):
    inputs, cfgs, outs = jax_run
    app = apps.get(name)
    plan = app.spmd_plan(device="cpu")
    grid = MatmulGrid(mesh=plan.mesh, axis_names=plan.axis_names)
    mine = _inputs_of(inputs, name)
    if app.kind == apps.MATMUL:
        a, b = state_from_numpy(name, (mine["a"], mine["b"]), "cpu")
        got = {name: ALGORITHMS[name].matmul(a, b, grid, use_kernel=True)}
    elif name == "stencil":
        field = state_from_numpy(name, mine["field"], "cpu")
        got = {name: stencil2d.run(field, grid, cfgs[name])}
    elif name == "pennant":
        state = state_from_numpy(name, [mine[f] for f in ("rho", "e", "u", "v")],
                                 "cpu")
        res = pennant.run(state, grid, cfgs[name])
        got = {f"{name}.{f}": r for f, r in zip(("rho", "e", "u", "v"), res)}
    else:
        state = state_from_numpy(name, mine, "cpu")
        got = {name: circuit.run(state, grid, cfgs[name])}
    for key, value in got.items():
        assert tuple(value.shape) == outs[key].shape, key
        np.testing.assert_allclose(value.numpy(), outs[key], **TOL,
                                   err_msg=key)


def _cli(*args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.apps.run", *args],
        capture_output=True, text=True, timeout=300, env=env,
    )


def test_cli_executes_all_nine_apps_on_cpu():
    proc = _cli("--all", "--execute", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.split()[-2:] == ["max_err", "ok"])
    rows = [ln.split() for ln in lines[head + 1:] if ln.strip()]
    assert [r[0] for r in rows] == list(apps.PAPER_APPS)
    assert all(r[-1] == "True" for r in rows), rows


def test_cli_without_a_card_refuses_the_default_device():
    """No card and no ``--device cpu``: a non-zero exit naming the missing
    card, never a quiet run on the CPU."""
    proc = _cli("--all", "--execute", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "GPU" in proc.stderr and "--device cpu" in proc.stderr
    assert "max_err" not in proc.stdout
