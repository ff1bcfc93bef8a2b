"""The port's production cells with values over one process per rank,
against the JAX package's jitted cells on fake devices.

The same whole values (made here from one seed with numpy: weights
N(0, 0.02), a decode cache N(0, 1), the optimizer's step and moments as
``steps.seeded_values`` makes them (the end of warmup, moments of scale
1e-8), so that every parameter moves past the limits and one left
unchanged fails them, token ids below the vocabulary) go to three runs
of each cell:

  * the reference: ``repro.launch.steps.make_cell`` jitted with its in
    and out shardings under ``with mesh:`` on 4 fake CPU devices as
    (data=2, model=2), or 8 as (pod=2, data=2, model=2), in one child
    process (``XLA_FLAGS=--xla_force_host_platform_device_count=8``);
  * the port on a gloo world of 4 CPU processes (8 for the folded cell),
    one a rank, through ``launch/dryrun.py::run_world_cells``: each rank
    places its blocks of the whole values (``Cell.place``), runs the
    step once and gathers the outputs (``Cell.gather``); the mesh's
    device ids come from a Mapple cyclic mapper (``linear_cyclic``);
  * the port's own step in this one process (``one_process_outputs``).

Reduced fp32 configs, S=64, global batch 4; the train cells accumulate
over 2 microbatches (``Knobs(microbatch=2)`` on both sides), and the
MoE capacity factor is 16 on both sides (no token dropped) but in one
cell at the default 1.25. Limits on every rank's gathered outputs:
against the reference, the loss within 1e-4 and every other leaf within
1e-4 of that leaf's largest |entry| (the mesh rule); against the
one-process step, 1e-5 of the largest |entry| for the dense, Hymba and
RWKV-6 cells, and for the MoE cells no more than the reference's own
gap from it. Each rank's blocks must have the shapes their specs give
at its mesh position.
"""
import dataclasses
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import GPU, Machine, linear_cyclic_mapper, spmd, world
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.knobs import Knobs
from repro_torch.models.config import ShapeConfig

REPO = Path(__file__).resolve().parent.parent
SEQ, BATCH, SEED = 64, 4, 0
REF_TOL = 1e-4          # against the reference: loss (absolute), each leaf (of its largest)
TWIN_TOL = 1e-5         # against the one-process step (of each leaf's largest)

# name: (arch, kind, mode, ranks, MoE capacity factor)
CELLS = {
    "smollm-train-fsdp": ("smollm-135m", "train", "fsdp", 4, 16.0),
    "smollm-train-tp": ("smollm-135m", "train", "tp", 4, 16.0),
    "qwen2moe-train": ("qwen2-moe-a2.7b", "train", None, 4, 16.0),
    "qwen2moe-train-cap1.25": ("qwen2-moe-a2.7b", "train", None, 4, 1.25),
    "qwen2moe-prefill-tp": ("qwen2-moe-a2.7b", "prefill", "tp", 4, 16.0),
    "hymba-prefill": ("hymba-1.5b", "prefill", None, 4, 16.0),
    "rwkv6-prefill": ("rwkv6-3b", "prefill", None, 4, 16.0),
    "smollm-decode": ("smollm-135m", "decode", None, 4, 16.0),
    "deepseek-decode": ("deepseek-v2-lite-16b", "decode", None, 4, 16.0),
    "hymba-decode": ("hymba-1.5b", "decode", None, 4, 16.0),
    "rwkv6-decode": ("rwkv6-3b", "decode", None, 4, 16.0),
    "smollm-train-folded": ("smollm-135m", "train", None, 8, 16.0),
}
MOE = {name for name, c in CELLS.items() if c[0].startswith(("qwen2-moe", "deepseek"))}
DECODE = [name for name, c in CELLS.items() if c[1] == "decode"]
TRAIN = [name for name, c in CELLS.items() if c[1] == "train"]

REF_SNIPPET = r'''
import dataclasses, json, sys, time
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch import knobs as jknobs, steps as jsteps
from repro.models import sharding as jshd
from repro.models.config import ShapeConfig

NAMES = {"train": ("state", "batch"), "prefill": ("params", "inputs"),
         "decode": ("params", "cache", "pos", "token")}

def kp(path, keypath):
    return "/".join([path] + [str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                              for k in keypath])

out_dir = sys.argv[1]
for job in json.loads(sys.argv[2]):
    t0 = time.time()
    cfg = dataclasses.replace(get_config(job["arch"]).reduced(), dtype="float32")
    shape = ShapeConfig(job["kind"], job["seq"], job["batch"], job["kind"])
    devs = np.array(jax.devices())[np.array(job["ids"])]
    mesh = Mesh(devs.reshape(job["shape"]), tuple(job["axes"]))
    knobs = jknobs.Knobs(microbatch=job["microbatch"], moe_capacity=job["capacity"])
    z = np.load(f"{out_dir}/{job['name']}.in.npz")
    with mesh, jknobs.apply(knobs):
        cell = jsteps.make_cell(job["arch"], cfg, shape, mesh, mode=job["mode"])
        args = []
        for name, a in zip(NAMES[job["kind"]], cell.abstract_args):
            def leaf(k, s, name=name):
                v = z[kp(name, k)]
                assert v.shape == tuple(s.shape) and v.dtype == s.dtype, (kp(name, k), v.shape, s)
                return v
            args.append(jax.tree_util.tree_map_with_path(leaf, a))
        fn = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                     out_shardings=cell.out_shardings)
        out = jax.block_until_ready(fn(*args))
    jshd.set_sequence_sharding(None)
    jshd.set_layer_barrier(False)
    jshd.set_moe_groups(1)
    flat = {kp("out", k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(out)[0]}
    np.savez(f"{out_dir}/{job['name']}.ref.npz", **flat)
    print(job["name"], cell.plan.mode, f"{time.time() - t0:.2f}s", flush=True)
'''


def _mesh(ranks: int) -> tuple[spmd.Mesh, tuple[str, ...]]:
    """The cell's mesh of virtual ids in a Mapple cyclic mapper's order,
    and the axes its DeviceMesh folds into one dim."""
    if ranks == 4:
        shape, axes, machine, fold = (2, 2), ("data", "model"), (2, 2), ()
    else:
        shape, axes, machine, fold = (2, 2, 2), ("pod", "data", "model"), (2, 4), \
            dryrun.MULTI_FOLD
    perm = tmesh.mapper_permutation(linear_cyclic_mapper(Machine(GPU, shape=machine)), shape)
    return spmd.Mesh(np.asarray(perm).reshape(shape), axes, "cpu"), fold


def _job(name: str, tmp: Path) -> dryrun.CellJob:
    arch, kind, mode, ranks, capacity = CELLS[name]
    mesh, fold = _mesh(ranks)
    return dryrun.CellJob(
        name=name, arch=arch,
        cfg=dataclasses.replace(get_config(arch).reduced(), dtype="float32"),
        shape=ShapeConfig(kind, SEQ, BATCH, kind), mesh=mesh, mode=mode, fold=fold,
        knobs=Knobs(microbatch=2 if kind == "train" else 0, moe_capacity=capacity),
        values=str(tmp / f"{name}.in.npz"),
        hold_to={"ref": str(tmp / f"{name}.ref.npz"), "twin": str(tmp / f"{name}.twin.pt")})


def _value(path: str, shape, dtype: torch.dtype, vocab: int):
    """The whole value at ``path`` from one seed, with numpy."""
    rng = np.random.default_rng([SEED, zlib.crc32(path.encode())])
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    if path == "state/opt/step":
        return np.full(shape, steps.SEEDED_STEP, np_dtype)
    if path.startswith("state/opt/nu/"):
        return ((0.5 + rng.random(size=shape)) * steps.SEEDED_MOMENT ** 2).astype(np_dtype)
    if not dtype.is_floating_point:
        return rng.integers(0, vocab, size=shape).astype(np_dtype)
    scale = (1.0 if path.startswith("cache") else
             steps.SEEDED_MOMENT if path.startswith("state/opt/mu/") else 0.02)
    return (rng.normal(size=shape) * scale).astype(np.float32).astype(np_dtype)


def _write_values(job: dryrun.CellJob) -> None:
    """``job.values``: every argument's whole value by path, shapes from
    the cell built on a fake world of the mesh's size."""
    vals = {}

    def one(path, x):
        if path == "pos":
            vals[path] = np.int32(x)
        elif isinstance(x, torch.Tensor):
            vals[path] = _value(path, tuple(x.shape), x.dtype, job.cfg.vocab_size)

    with world.world("fake", int(job.mesh.device_ids.size)):
        mesh = world.on_world(job.mesh, "meta", device_type="cpu", fold=job.fold)
        cell = steps.make_cell(job.arch, job.cfg, job.shape, mesh, mode=job.mode)
    for name, a in zip(steps.ARG_NAMES[job.shape.kind], cell.abstract_args):
        steps._tree_at(one, name, a)
    assert (job.shape.kind == "train") == ("state/opt/step" in vals)
    np.savez(job.values, **vals)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every cell through the reference (child process), the port's
    one-process step (here, meanwhile) and the gloo worlds."""
    tmp = tmp_path_factory.mktemp("cells")
    jobs = {name: _job(name, tmp) for name in CELLS}
    for job in jobs.values():
        _write_values(job)
    spec = [{"name": j.name, "arch": j.arch, "kind": j.shape.kind, "mode": j.mode,
             "seq": SEQ, "batch": BATCH, "ids": j.mesh.device_ids.reshape(-1).tolist(),
             "shape": list(j.mesh.shape), "axes": list(j.mesh.axis_names),
             "microbatch": j.knobs.microbatch, "capacity": j.knobs.moe_capacity}
            for j in jobs.values()]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.setdefault("JAX_PLATFORMS", "cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF_SNIPPET, str(tmp), json.dumps(spec)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=env)
    try:
        for job in jobs.values():
            torch.save(dryrun.one_process_outputs(job, "cpu")[0], job.hold_to["twin"])
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, stdout[-3000:] + stderr[-3000:]
    print(stdout)
    worlds = dryrun.run_world_cells(list(jobs.values()), "gloo", "cpu", timeout=600)
    # the reference's own gap from the port's one-process step, leaf by leaf
    ref_gap = {}
    for name, job in jobs.items():
        twin = torch.load(job.hold_to["twin"])
        with np.load(job.hold_to["ref"]) as z:
            ref_gap[name] = {p: [float((torch.from_numpy(z[p]).double() - t.double())
                                       .abs().max()), float(t.abs().max())]
                             for p, t in twin.items()}
    return {"jobs": jobs, "reports": {n: r for n, r in worlds.items()}, "ref_gap": ref_gap}


def _rows(runs, name):
    """Every rank's row of cell ``name``, each checked to have run."""
    rows = runs["reports"][CELLS[name][3]]
    for rank, report in enumerate(rows):
        row = report[name]
        assert "error" not in row, (name, rank, row.get("traceback", row.get("error")))
    return [r[name] for r in rows]


def _worst(held: dict) -> tuple[float, str]:
    """The largest leaf difference over its largest |entry| (the loss
    counts absolutely), and its path."""
    def rel(p, v):
        return v[0] if p == "out/1/loss" else v[0] / max(v[1], 1e-30)
    return max((rel(p, v), p) for p, v in held.items())


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_matches_the_references_jitted_cell(runs, name):
    """Every rank's gathered outputs within 1e-4 of the reference's
    (the loss absolutely, each other leaf of its largest |entry|)."""
    for rank, row in enumerate(_rows(runs, name)):
        err, path = _worst(row["held"]["ref"])
        print(f"{name} rank {rank}: worst vs the reference {err:.3e} at {path}")
        assert err <= REF_TOL, (name, rank, path, err)


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_matches_the_one_process_step(runs, name):
    """Dense, Hymba and RWKV-6 cells within 1e-5 of each leaf's largest
    |entry| of the port's one-process step; an MoE cell no further from it
    than the reference's own cell is (routing groups and capacity are per
    data shard on a mesh, by design), leaf by leaf."""
    ref_gap = runs["ref_gap"][name]
    for rank, row in enumerate(_rows(runs, name)):
        held = row["held"]["twin"]
        if name not in MOE:
            err, path = _worst(held)
            assert err <= TWIN_TOL, (name, rank, path, err)
            continue
        for path, (diff, scale) in held.items():
            ref_diff = ref_gap[path][0]
            print(f"{name} rank {rank} {path}: port {diff / max(scale, 1e-30):.3e}, "
                  f"reference {ref_diff / max(scale, 1e-30):.3e} of the largest |entry|")
            assert diff <= ref_diff + REF_TOL * scale, (name, rank, path, diff, ref_diff)


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_runs_each_rank_on_its_own_blocks(runs, name):
    """Each rank's blocks have the shapes their specs give at its mesh
    position (torch.chunk's cut, mesh dim by mesh dim), on the CPU; the
    plain route launches no kernel; a gloo CPU world stages nothing."""
    job = runs["jobs"][name]
    mesh = job.mesh
    groups = spmd.Mesh(mesh.device_ids, mesh.axis_names, "cpu", fold=job.fold).dist_axes()
    with np.load(job.values) as z:
        shapes = {p: z[p].shape for p in z.files}
    coords_seen = set()
    for row in _rows(runs, name):
        coords = row["coords"]
        coords_seen.add(tuple(coords))
        assert row["local_devices"] == ["cpu"] and row["output_devices"] == ["cpu"]
        assert not any(row["launches"].values()) and row["staged"] == {}
        for path, (local, spec) in row["blocks"].items():
            want = list(shapes[path])
            for d, e in enumerate(spec):
                names = [] if e is None else [e] if isinstance(e, str) else e
                for g, group in enumerate(groups):
                    if set(group) & set(names):
                        n = int(np.prod([mesh.axis_size(a) for a in group]))
                        step = -(-want[d] // n)
                        lo = min(coords[g] * step, want[d])
                        want[d] = min(lo + step, want[d]) - lo
            assert local == want, (name, path, coords, spec, local, want)
    assert len(coords_seen) == CELLS[name][3]


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_moves_every_parameter_past_the_limit(runs, name):
    """The reference's step changes every parameter leaf by more than
    the limit (1e-4 of its largest |entry|), so a parameter that the
    port's sharded step failed to write would fail
    ``test_cell_matches_the_references_jitted_cell``."""
    job = runs["jobs"][name]
    with np.load(job.values) as before, np.load(job.hold_to["ref"]) as after:
        moved = {p: float(np.abs(after[p] - before["state" + p[len("out/0"):]]).max()
                          / np.abs(after[p]).max())
                 for p in after.files if p.startswith("out/0/params/")}
    least = min(moved, key=moved.get)
    print(f"{name}: least update {moved[least]:.3e} of its leaf's largest at {least}")
    assert len(moved) > 1 and moved[least] > REF_TOL, (least, moved[least])


@pytest.mark.parametrize("name", DECODE)
def test_decode_step_runs_and_writes_its_cache_on_a_process_group(runs, name):
    """The decode step on a real group: the embedded token no longer a
    pending masked sum at the first norm (dense, MLA, Hymba and RWKV-6),
    and the new token's K and V written into the rank whose cache block
    holds position 63 (a cache cut along its sequence). The logits and
    every cache leaf match the reference's."""
    for row in _rows(runs, name):
        held = row["held"]["ref"]
        assert "out/0" in held and any(p.startswith("out/1/") for p in held)
        for path, (diff, scale) in held.items():
            assert diff <= REF_TOL * scale, (name, path, diff, scale)


def test_moe_train_gradient_sums_over_its_replicas(runs):
    """qwen2-moe-a2.7b's train cell (no drops): the expert weights' blocks
    are replicated over 'data' inside the EP shard_map, so each rank's
    gradient is a partial sum over the data ranks; the grad norm and the
    experts' moments match the reference's and the one-process step's."""
    name = "qwen2moe-train"
    for rank, row in enumerate(_rows(runs, name)):
        for label in ("ref", "twin"):
            held = row["held"][label]
            for path in ("out/1/grad_norm", "out/0/opt/mu/moe_layers/moe/w_gate",
                         "out/0/opt/nu/moe_layers/moe/w_down"):
                diff, scale = held[path]
                print(f"rank {rank} {path} vs {label}: {diff / scale:.3e} of its largest")
                assert diff <= REF_TOL * scale, (rank, label, path, diff, scale)
    gn_ref = runs["ref_gap"][name]["out/1/grad_norm"]
    print(f"grad_norm: reference vs one-process {gn_ref[0] / gn_ref[1]:.3e}")


def test_moe_capacity_drops_as_the_reference_drops(runs):
    """At the default capacity factor 1.25 both meshes drop tokens per
    data shard: the port's cell matches the reference's within 1e-4, and
    its grad norm is as far from the one-process step as the reference's."""
    name = "qwen2moe-train-cap1.25"
    ref_gap = runs["ref_gap"][name]["out/1/grad_norm"]
    for row in _rows(runs, name):
        diff, scale = row["held"]["twin"]["out/1/grad_norm"]
        print(f"grad_norm vs the one-process step: port {diff / scale:.3e}, "
              f"reference {ref_gap[0] / scale:.3e}")
        assert abs(diff - ref_gap[0]) <= REF_TOL * scale


def test_moe_train_on_virtual_ranks_matches_the_reference(runs):
    """The same qwen2-moe-a2.7b train cell on (data=2, model=2) virtual
    ranks in this one process (the stacked backend of ``core/spmd.py``):
    every output within 1e-4 of the reference's. The MoE z-loss is local
    to a rank and its output replicated, so this holds only when each
    replica gets its share of the gradient (``_TakeReplica``), as JAX's
    transpose gives it."""
    from repro_torch.launch import knobs as knobs_mod

    job = runs["jobs"]["qwen2moe-train"]
    with world.world("fake", int(job.mesh.device_ids.size)), knobs_mod.apply(job.knobs):
        cell = steps.make_cell(job.arch, job.cfg, job.shape,
                               world.on_world(job.mesh, "meta", device_type="cpu"),
                               mode=job.mode)
    args = cell.whole(dryrun.job_values(job, "cpu"), "cpu")
    spmd.reset_counts()
    with knobs_mod.apply(job.knobs), steps.mesh_settings(job.cfg, job.shape, job.mesh,
                                                         mode=cell.plan.mode):
        out = dryrun.outputs_by_path(cell.step_fn(*args))
    assert spmd.counts().get("moe_shard_map", 0) > 0
    with np.load(job.hold_to["ref"]) as z:
        for path, got in out.items():
            want = torch.from_numpy(z[path]).double()
            err = float((got.detach().double() - want).abs().max())
            scale = 1.0 if path == "out/1/loss" else float(want.abs().max())
            assert err <= REF_TOL * scale, (path, err, scale)

