"""The slice as a whole: the nine apps in the port against the JAX package.

One child process (8 fake CPU devices, as ``tests/test_distributed.py``
runs its meshes) executes the JAX package's ``ALGORITHMS[...].matmul``,
``stencil2d.run``, ``pennant.run`` and ``circuit.run`` at the sizes of
``repro/apps/validate.py``, on inputs made here with numpy. The port runs
the same inputs on the CPU, carried over by ``state_from_numpy``, with the
matmul bodies on the kernel path (``use_kernel=True``). Outputs agree
within the fp32 tolerance of ``tests/test_kernels.py``: the arithmetic is
the same, only the summation order differs (blocking, scatter-add).

The same inputs also go through the port with one process per mesh
rank: a gloo world of 4 CPU processes (Cannon, SUMMA, PUMMA) and one of 8
(the other six apps), each spawned once with its own time limit, every
rank on the device its mesh position's ``device_ids`` entry binds it to
(the CPU here). Every rank's whole result (gathered from all ranks) is
held to the JAX package's within the same tolerance, and to the virtual
ranks' within 1e-5 of its largest |entry|.

The six matmul algorithms also run once on bf16 inputs with
``use_kernel=True`` on both sides: the JAX package through its
interpreted ``matmul_pallas``, the port through ``ref.matmul``. Each block
product is rounded to bf16 before it is summed, so the two agree within
the JAX package's bf16 kernel tolerance, 2e-2, taken relative to the
largest entry (the entries reach about 4 sqrt(K)).
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.science import circuit as jcircuit
from repro_torch import apps
from repro_torch.apps.state import state_from_numpy
from repro_torch.matmul import ALGORITHMS
from repro_torch.matmul.common import MatmulGrid
from repro_torch.science import circuit, pennant, stencil2d

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 2e-2
VIRTUAL_REL = 1e-5
WORLD_SIZES = (4, 8)
WORLD_TIMEOUT_S = 180

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
        out[k + ".bf16"] = ALGORITHMS[k].matmul(
            jnp.asarray(inp[k + ".a16"], jnp.bfloat16),
            jnp.asarray(inp[k + ".b16"], jnp.bfloat16), grid,
            use_kernel=True).astype(jnp.float32)
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


# One rank of a gloo world: the apps whose default processor count is the
# world's size, on this rank's blocks, from the shared numpy inputs; every
# output's full tensor, local block shape and the shard_map count saved.
WORLD_SNIPPET = r"""
import sys
import numpy as np, torch
from repro_torch import apps
from repro_torch.apps.state import state_from_numpy
from repro_torch.core import spmd, world
from repro_torch.matmul import ALGORITHMS
from repro_torch.matmul.common import MatmulGrid
from repro_torch.science import circuit, pennant, stencil2d

rank, n, port = (int(a) for a in sys.argv[1:4])
inp = np.load(sys.argv[4])
torch.set_num_threads(1)
out = {}
with world.world("gloo", n, rank=rank, address=f"tcp://127.0.0.1:{port}") as w:
    for app in apps.iter_apps():
        if app.default_procs != n:
            continue
        k = app.name
        plan = app.spmd_plan(n, device="cpu")
        grid = MatmulGrid(mesh=w.place(plan.mesh), axis_names=plan.axis_names)
        mine = {f.split(".", 1)[1]: inp[f] for f in inp.files if f.startswith(k + ".")}
        spmd.reset_counts()
        if app.kind == apps.MATMUL:
            a, b = state_from_numpy(k, (mine["a"], mine["b"]), "cpu")
            got = {k: ALGORITHMS[k].matmul(a, b, grid, use_kernel=True)}
        elif k == "stencil":
            gx, gy = grid.shape
            cfg = stencil2d.StencilConfig(nx=16 * gx, ny=16 * gy, steps=2)
            got = {k: stencil2d.run(state_from_numpy(k, mine["field"], "cpu"), grid, cfg)}
        elif k == "pennant":
            gx, gy = grid.shape
            cfg = pennant.PennantConfig(nzx=16 * gx, nzy=16 * gy, steps=2)
            fields = ("rho", "e", "u", "v")
            res = pennant.run(state_from_numpy(k, [mine[f] for f in fields], "cpu"),
                              grid, cfg)
            got = {f"{k}.{f}": r for f, r in zip(fields, res)}
        else:
            cfg = circuit.CircuitConfig(pieces=n, steps=2)
            got = {k: circuit.run(state_from_numpy(k, mine, "cpu"), grid, cfg)}
        ran = spmd.counts()["shard_map"]
        for key, v in got.items():
            out[key] = v.full_tensor().numpy()
            out[key + ".local"] = np.asarray(v.to_local().shape)
            out[key + ".device"] = np.asarray(str(v.to_local().device))
            out[key + ".ran"] = np.asarray(ran)
np.savez(sys.argv[5], **out)
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
            for f in ("a16", "b16"):    # fp32 values that bf16 holds exactly
                x = torch.from_numpy(rng.normal(size=(size, size)).astype(np.float32))
                inputs[k + "." + f] = x.to(torch.bfloat16).float().numpy()
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


def _virtual_outputs(inputs, cfgs, name) -> dict:
    """The port's outputs of ``name`` on virtual ranks, by output key."""
    app = apps.get(name)
    plan = app.spmd_plan(device="cpu")
    grid = MatmulGrid(mesh=plan.mesh, axis_names=plan.axis_names)
    mine = _inputs_of(inputs, name)
    if app.kind == apps.MATMUL:
        a, b = state_from_numpy(name, (mine["a"], mine["b"]), "cpu")
        return {name: ALGORITHMS[name].matmul(a, b, grid, use_kernel=True)}
    if name == "stencil":
        field = state_from_numpy(name, mine["field"], "cpu")
        return {name: stencil2d.run(field, grid, cfgs[name])}
    if name == "pennant":
        state = state_from_numpy(name, [mine[f] for f in ("rho", "e", "u", "v")],
                                 "cpu")
        res = pennant.run(state, grid, cfgs[name])
        return {f"{name}.{f}": r for f, r in zip(("rho", "e", "u", "v"), res)}
    state = state_from_numpy(name, mine, "cpu")
    return {name: circuit.run(state, grid, cfgs[name])}


@pytest.mark.parametrize("name", list(apps.PAPER_APPS))
def test_port_matches_jax_package(jax_run, name):
    inputs, cfgs, outs = jax_run
    got = _virtual_outputs(inputs, cfgs, name)
    for key, value in got.items():
        assert tuple(value.shape) == outs[key].shape, key
        np.testing.assert_allclose(value.numpy(), outs[key], **TOL,
                                   err_msg=key)


@pytest.fixture(scope="module")
def gloo_apps(jax_run, tmp_path_factory):
    """Every rank's outputs of the apps on gloo worlds of 4 and 8 CPU
    processes, from the inputs ``jax_run`` used: ``{n: [rank's npz]}``."""
    inputs, _, _ = jax_run
    d = tmp_path_factory.mktemp("gloo_apps")
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    runs = {}
    for n in WORLD_SIZES:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        logs = [open(d / f"log{n}_{r}.txt", "w") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORLD_SNIPPET, str(r), str(n), str(port),
             str(d / "inputs.npz"), str(d / f"rank{n}_{r}.npz")],
            stdout=logs[r], stderr=subprocess.STDOUT, env=env) for r in range(n)]
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        try:
            codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                     for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        assert codes == [0] * n, (codes, (d / f"log{n}_0.txt").read_text()[-3000:])
        runs[n] = [dict(np.load(d / f"rank{n}_{r}.npz")) for r in range(n)]
    return runs


def _world_outputs(gloo_apps, name):
    """(output key, rank, saved arrays) of each output of ``name``, each rank."""
    ranks = gloo_apps[apps.get(name).default_procs]
    keys = [k for k in ranks[0] if (k == name or k.startswith(name + "."))
            and k.rsplit(".", 1)[-1] not in ("local", "device", "ran")]
    assert keys, name
    return [(key, r, arrays) for key in keys for r, arrays in enumerate(ranks)]


@pytest.mark.parametrize("name", list(apps.PAPER_APPS))
def test_process_group_apps_match_jax_package(jax_run, gloo_apps, name):
    """Every rank's whole result, gathered from the ranks of its world,
    within the fp32 tolerance of the JAX package's 8-fake-device run; each
    rank ran the body once on its own block (not the stacked blocks)."""
    _, _, outs = jax_run
    for key, rank, arrays in _world_outputs(gloo_apps, name):
        np.testing.assert_allclose(arrays[key], outs[key], **TOL,
                                   err_msg=f"{key} rank {rank}")
        local = tuple(int(x) for x in arrays[key + ".local"])
        assert len(local) == outs[key].ndim and np.prod(local) < outs[key].size, local
        assert str(arrays[key + ".device"]) == "cpu"
        assert int(arrays[key + ".ran"]) >= 1


@pytest.mark.parametrize("name", list(apps.PAPER_APPS))
def test_process_group_apps_match_virtual_ranks(jax_run, gloo_apps, name):
    """Every rank's whole result within 1e-5 of the largest |entry| of the
    virtual ranks' output on the same inputs."""
    inputs, cfgs, _ = jax_run
    want = {k: v.numpy() for k, v in _virtual_outputs(inputs, cfgs, name).items()}
    for key, rank, arrays in _world_outputs(gloo_apps, name):
        got = arrays[key]
        assert got.shape == want[key].shape, key
        diff = float(np.abs(got.astype(np.float64) - want[key]).max())
        assert diff <= VIRTUAL_REL * float(np.abs(want[key]).max()), (key, rank, diff)


@pytest.mark.parametrize("name", [a.name for a in apps.iter_apps(kind=apps.MATMUL)])
def test_port_matches_jax_package_bf16(jax_run, name):
    """bf16 inputs through the kernel path on both sides."""
    inputs, _, outs = jax_run
    app = apps.get(name)
    plan = app.spmd_plan(device="cpu")
    grid = MatmulGrid(mesh=plan.mesh, axis_names=plan.axis_names)
    mine = _inputs_of(inputs, name)
    a, b = (torch.from_numpy(mine[f]).to(torch.bfloat16) for f in ("a16", "b16"))
    got = ALGORITHMS[name].matmul(a, b, grid, use_kernel=True)
    want = outs[name + ".bf16"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= BF16_REL * float(np.abs(want).max()), (err, float(np.abs(want).max()))


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


def test_cli_executes_all_nine_apps_on_gloo_worlds():
    """``--world gloo --device cpu``: one world of 4 and one of 8 CPU
    processes, nine ok rows, each naming its world."""
    proc = _cli("--all", "--execute", "--world", "gloo", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "world: gloo, 4 and 8 processes, blocks on cpu" in proc.stdout
    head = next(i for i, ln in enumerate(lines) if ln.split()[-4:] ==
                ["world", "wall_ms", "launches", "staged_B"])
    rows = [ln.split() for ln in lines[head + 1:head + 10]]
    assert [r[0] for r in rows] == list(apps.PAPER_APPS)
    assert all(r[3] == "True" for r in rows), rows
    assert [r[4] for r in rows] == [f"gloo/{a.default_procs}" for a in apps.iter_apps()]
    assert "staged through host memory: none" in proc.stdout


def test_cli_world_flags_need_execute_and_a_card():
    """``--world`` without ``--execute`` and ``--share-card`` off CUDA are
    usage errors; ``--world nccl`` on a host with no card stops as the
    default device does, before any world is spawned."""
    assert _cli("--all", "--world", "gloo", "--device", "cpu").returncode == 2
    assert _cli("--all", "--execute", "--world", "gloo", "--device", "cpu",
                "--share-card").returncode == 2
    proc = _cli("--all", "--execute", "--world", "nccl",
                env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "GPU" in proc.stderr
    assert "wall_ms" not in proc.stdout


@pytest.mark.parametrize("kind", ["nccl", "gloo"])
def test_execute_world_refuses_a_world_the_host_cannot_give(monkeypatch, capsys, kind):
    """One card for worlds of 4 and 8 ranks: NCCL, and gloo on CUDA
    without ``--share-card``, exit 1 naming the card and the ranks, and
    spawn nothing."""
    from repro_torch.apps import run
    from repro_torch.core import world

    monkeypatch.setattr(world, "cards", lambda: ["NVIDIA H100 80GB HBM3"])
    selection = list(apps.iter_apps())
    rows = [{"procs": a.default_procs} for a in selection]
    rc = run.execute_world(selection, rows, "cuda", kind)
    err = capsys.readouterr().err
    assert rc == 1
    assert "1 card(s) (NVIDIA H100 80GB HBM3)" in err and " ranks" in err, err


def test_run_worlds_fails_when_a_rank_fails():
    """A rank that raises ends its world and the call with an error."""
    code = ("from repro_torch.apps import run\n"
            "run.run_worlds([('no-such-app', 2)], 'gloo', 'cpu', timeout=120)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=180, env=env)
    assert proc.returncode != 0
    assert "a rank of the world of 2 failed" in proc.stderr, proc.stderr[-2000:]
