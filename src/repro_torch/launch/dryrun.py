"""Dry run of every (arch x shape) cell on one card: count, roofline, run.

The port of ``repro.launch.dryrun``. The reference lowers and compiles
each cell for a TPU mesh and reads its FLOPs, bytes and collectives from
the HLO. With one card and no XLA, a cell here is:

  * on ``--device meta``: the loop-aware count of the cell's step at the
    shape's own global batch (``launch/flops.py``: the train step with
    ``choose_microbatches``' accumulation, the plain prefill, or one
    decode step), and the three roofline terms at one H100's rates
    (``roofline.H100``); the memory term rests on unfused bytes, an upper
    bound;
  * on ``--device cuda`` (the default): the same count, then the step
    once on the card at ``--batch`` (default: the shape's global batch)
    from seeded weights, through the kernels for a prefill
    (``use_kernel=True``; decode and train run their plain steps, as in
    the reference). The record adds the step's warm seconds, its peak
    memory, the kernels' launches, ``roofline_share`` and the unfused
    bytes over the seconds (an upper bound on the bandwidth reached, not
    a share). ``roofline_share`` is the model FLOPs at that batch
    (``roofline.model_flops``) over the seconds and the bf16 peak: the
    count is of the plain route, which computes attention chunk pairs
    that the flash kernel skips (every causal pair, also those wholly
    left of a sliding window), so it overstates the kernel route's work.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --device meta
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device meta \\
      --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b \\
      --shape prefill_32k --batch 1

A cell runs under ``steps.mesh_settings`` with no mesh, as one card is.

``--mesh single|multi|both`` counts the reference's production meshes
instead: 256 chips as (data=16, model=16), 512 as (pod=2, data=16,
model=16). Each cell's step runs on DTensors over a fake process group
of that many ranks in this one process (``core/world.py``), placed by
``launch/policy.py``'s ``ShardingPlan`` (``launch/steps.py::make_cell``),
and the count (``Cell.count``) is rank (0, 0[, 0])'s: per-device FLOPs,
unfused bytes, and collective bytes by the reference's five kinds, both
those of the shard_map bodies and those DTensor inserts. ``--mode``
overrides the sharding mode, ``--no-seq-shard`` turns sequence sharding
off. On ``--device cuda`` rank 0's share then runs once on the card
(``Cell.run``: seeded local blocks, the fake group moving no data) for
its peak memory. The record keeps the reference's names:
``memory_analysis`` (argument, output and aliased bytes of this rank's
blocks; ``temp_size_in_bytes`` the card's peak less the arguments, null
on meta), ``flops`` and ``bytes_accessed`` per device (unfused),
``collective_bytes``, ``collectives`` and the roofline (the machine
model's rates on meta, as the reference's; ``roofline.H100`` on the
card), plus ``model_flops_share``, the reference's
``useful_flops_ratio``. These cells launch no kernel, as the
reference's do not (``use_pallas=False``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
      --device meta --out results/dryrun_mesh_torch.json

``run_world_cells`` runs cells with values instead, one process per
mesh rank on a gloo world (the cells' counterpart of
``apps/run.py::run_worlds``): each rank runs its share of the step on
its blocks of whole values and gathers the outputs, which are held to
files of whole outputs (the reference's, or the same step in one
process, ``one_process_outputs``). It has no CLI flag, as the
reference's launchers have none for it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any

import torch

# The record's mesh: one card, no mesh axes.
MESH = "1card"


def card_inputs(cfg, shape, batch: int, *, seed: int = 0):
    """The model, seeded weights and the step's inputs for one cell at
    ``batch``: (model, params, args) where args follow the params in the
    step's call: the prompt (B, S) int32 (embeddings for stub front
    ends), or a zero cache, the last position and one token, or a train
    state and batch."""
    from repro_torch.models.registry import build

    device = "cuda"
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed), device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    S = 1 if shape.kind == "decode" else shape.seq_len

    def inputs():
        if cfg.stub_frontend:
            return torch.randn((batch, S, cfg.d_model), generator=gen, device=device,
                               dtype=torch.bfloat16)
        return torch.randint(0, cfg.vocab_size, (batch, S), generator=gen,
                             device=device, dtype=torch.int32)

    if shape.kind == "prefill":
        return model, params, (inputs(),)
    if shape.kind == "decode":
        cache = model.init_cache(batch, shape.seq_len, device=device)
        return model, params, (cache, shape.seq_len - 1, inputs())
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.loop import TrainState

    labels_shape = (batch, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (batch, S)
    labels = torch.randint(0, cfg.vocab_size, labels_shape, generator=gen, device=device,
                           dtype=torch.int32)
    return model, TrainState(params, opt_mod.init(params)), ({"inputs": inputs(),
                                                              "labels": labels},)


def _card_step(cfg, shape, batch: int) -> dict:
    """The cell's step once on the card after one warm run: seconds,
    peak memory since a reset just before it, launches, finite output."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    model, first, args = card_inputs(cfg, shape, batch)
    if shape.kind == "prefill":
        step = steps.make_prefill_step(model, use_kernel=True)
    elif shape.kind == "decode":
        step = steps.make_serve_step(model)
    else:
        step = steps.make_train_step(model, dataclasses.replace(shape, global_batch=batch))
    step(first, *args)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(first, *args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    value = out[1]["loss"] if shape.kind == "train" else (
        out[0] if shape.kind == "decode" else out)
    if not bool(torch.isfinite(value.float()).all()):
        raise FloatingPointError(f"{cfg.name} x {shape.name}: non-finite step output")
    return {"step_s": seconds, "peak_memory_bytes": peak, "launches": launches,
            "output_shape": list(value.shape)}


def run_cell(arch: str, shape_name: str, *, device: str = "cuda", batch: int | None = None,
             knobs=None, verbose: bool = True, cfg=None) -> dict:
    """One cell's record (the reference's fields, with one card in place of
    the mesh and the run's seconds in place of ``compile_s``). ``cfg``
    replaces ``arch``'s published config (a test's reduced one)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import flops, roofline, steps
    from repro_torch.launch import knobs as knobs_mod
    from repro_torch.launch.specs import runnable
    from repro_torch.models.config import SHAPES

    if device not in ("meta", "cuda"):
        raise ValueError(f"device {device!r}: the dry run counts on 'meta' and runs on 'cuda'")
    if knobs is None:
        knobs = knobs_mod.Knobs()
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = runnable(cfg, shape)
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": MESH, "device": device,
        "status": "skipped" if not ok else "pending",
    }
    if not ok:
        record["reason"] = why
        if verbose:
            print(f"[skip] {arch} x {shape_name} x {MESH}: {why}")
        return record

    t0 = time.time()
    try:
        with knobs_mod.apply(knobs), steps.mesh_settings(cfg, shape):
            costs = flops.count_cell(cfg, shape)
            rt = roofline.terms(
                arch, shape, cfg, MESH, 1,
                {"flops": costs.flops, "bytes accessed": costs.bytes_unfused},
                costs.collective_bytes, **roofline.H100)
            record.update(
                status="ok", n_chips=1, global_batch=shape.global_batch,
                count_s=costs.seconds,
                flops=rt.hlo_flops, bytes_accessed=rt.hlo_bytes,
                bytes_unfused=costs.bytes_unfused, argument_bytes=costs.argument_bytes,
                collective_bytes=costs.collective_bytes,
                collectives={"bytes": costs.collective_by_kind},
                roofline={
                    "compute_s": rt.compute_s,
                    "memory_s": rt.memory_s,
                    "memory_s_is": "upper bound (unfused bytes)",
                    "collective_s": rt.collective_s,
                    "bottleneck": rt.bottleneck,
                    "model_flops": rt.model_flops,
                    "useful_flops_ratio": rt.flops_ratio,
                    "rates": dict(roofline.H100),
                },
                knobs=dataclasses.asdict(knobs),
            )
            if device == "cuda":
                used = batch or shape.global_batch
                at = dataclasses.replace(shape, global_batch=used)
                here = costs if used == shape.global_batch else flops.count_cell(cfg, at)
                card = _card_step(cfg, shape, used)
                record.update(
                    card=torch.cuda.get_device_name(0), batch=used,
                    flops_at_batch=here.flops, **card,
                    model_flops_at_batch=roofline.model_flops(cfg, at),
                    roofline_share=(roofline.model_flops(cfg, at)
                                    / roofline.H100["peak_flops"] / card["step_s"]),
                    bytes_unfused_per_s_upper=here.bytes_unfused / card["step_s"],
                )
                if used != shape.global_batch:
                    record["reduced"] = {"global_batch": [shape.global_batch, used]}
        record["run_s"] = time.time() - t0
        if verbose:
            print(f"[ok]   {arch} x {shape_name} x {MESH} ({record['run_s']:.1f}s, "
                  f"count {costs.seconds:.1f}s)")
            print(f"       cost: flops={rt.hlo_flops:.3e} "
                  f"bytes_unfused={rt.hlo_bytes:.3e} coll=0.0MiB")
            print(f"       roofline (H100): compute={rt.compute_s:.3e}s "
                  f"memory<={rt.memory_s:.3e}s coll={rt.collective_s:.3e}s "
                  f"-> {rt.bottleneck}-bound, useful={rt.flops_ratio:.2f}")
            if device == "cuda":
                print(f"       card: B={record['batch']} step {record['step_s']:.4f}s, "
                      f"peak {record['peak_memory_bytes'] / 1e9:.2f} GB, "
                      f"model flops at {record['roofline_share']:.2%} of the bf16 "
                      f"peak, launches "
                      f"{ {k: v for k, v in record['launches'].items() if v} }")
    except Exception as e:  # noqa: BLE001 - report, continue the sweep
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR]  {arch} x {shape_name} x {MESH}: {e}")
    return record


MESHES = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"]}
MULTI_FOLD = ("pod", "data")


def run_mesh_cell(arch: str, shape_name: str, mesh_name: str, *, device: str = "meta",
                  mode: str | None = None, seq_shard: bool = True, knobs=None,
                  verbose: bool = True, cfg=None) -> dict:
    """One cell on a production mesh (the reference's ``run_cell``): the
    count of rank (0, ...)'s share on a fake group, and on ``cuda`` that
    share run once on the card. ``cfg`` replaces ``arch``'s published
    config (a test's reduced one)."""
    import logging

    from repro_torch.configs import get_config
    from repro_torch.core import world
    from repro_torch.launch import knobs as knobs_mod
    from repro_torch.launch import flops, roofline, steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import runnable
    from repro_torch.models.config import SHAPES

    if device not in ("meta", "cuda"):
        raise ValueError(f"device {device!r}: the dry run counts on 'meta' and runs on 'cuda'")
    if knobs is None:
        knobs = knobs_mod.Knobs()
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = runnable(cfg, shape)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "device": device,
                    "status": "skipped" if not ok else "pending"}
    if not ok:
        record["reason"] = why
        if verbose:
            print(f"[skip] {arch} x {shape_name} x {mesh_name}: {why}")
        return record
    # DTensor warns at every reduction of a partial sum over two mesh dims.
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    base = make_production_mesh(multi_pod=mesh_name == "multi", device="meta")
    # DTensor's sharding propagation on a 3-D mesh took 17 s a matmul (torch
    # 2.13); every spec names 'pod' and 'data' together but ZeRO-1's
    # moments, so the multi mesh's DeviceMesh folds them into one dim.
    fold = MULTI_FOLD if mesh_name == "multi" else ()
    n_chips = int(base.device_ids.size)
    t0 = time.time()
    try:
        with world.world("fake", n_chips, rank=world.ORIGIN_RANK), knobs_mod.apply(knobs):
            mesh = world.on_world(base, "meta", device_type="cuda", fold=fold)
            cell = steps.make_cell(arch, cfg, shape, mesh, mode=mode, seq_shard=seq_shard)
            costs = cell.count()
            rank0 = cell.run("cuda") if device == "cuda" else None
        rates = roofline.H100 if device == "cuda" else {}
        rt = roofline.terms(arch, shape, cfg, mesh_name, n_chips,
                            {"flops": costs.flops, "bytes accessed": costs.bytes_unfused},
                            costs.collective_bytes, **rates)
        temp = None
        if rank0 is not None:
            if rank0["local_devices"] != ["cuda:0"]:
                raise RuntimeError(f"rank 0's blocks lie on {rank0['local_devices']}, "
                                   f"not on the card")
            temp = rank0["peak_memory_bytes"] - rank0["argument_bytes"]
        record.update(
            status="ok", n_chips=n_chips, global_batch=shape.global_batch,
            count_s=costs.seconds,
            memory_analysis={
                "argument_size_in_bytes": int(costs.argument_bytes),
                "output_size_in_bytes": int(costs.output_bytes),
                "alias_size_in_bytes": int(costs.alias_bytes),
                "temp_size_in_bytes": temp,
            },
            flops=rt.hlo_flops, bytes_accessed=rt.hlo_bytes,
            bytes_accessed_is="per device, unfused (an upper bound)",
            collective_bytes=costs.collective_bytes,
            collectives={"bytes": costs.collective_by_kind,
                         "counts": costs.collective_count_by_kind,
                         "ops": flops.dominant_ops(costs, None)},
            roofline={
                "compute_s": rt.compute_s, "memory_s": rt.memory_s,
                "memory_s_is": "upper bound (unfused bytes)",
                "collective_s": rt.collective_s, "bottleneck": rt.bottleneck,
                "model_flops": rt.model_flops, "useful_flops_ratio": rt.flops_ratio,
                "rates": dict(rates) or "machine model (core/machine.py)",
            },
            model_flops_share=rt.flops_ratio,
            sharding_mode=cell.plan.mode, seq_shard=seq_shard, fold=list(fold),
            knobs=dataclasses.asdict(knobs),
        )
        if rank0 is not None:
            record.update(card=torch.cuda.get_device_name(0), rank0=rank0)
        record["run_s"] = time.time() - t0
        if verbose:
            print(f"[ok]   {arch} x {shape_name} x {mesh_name} ({record['run_s']:.1f}s, "
                  f"mode={cell.plan.mode})")
            print(f"       memory: {record['memory_analysis']}")
            print(f"       cost: flops={rt.hlo_flops:.3e} bytes_unfused={rt.hlo_bytes:.3e} "
                  f"coll={costs.collective_bytes / 2**20:.1f}MiB")
            print(flops.CollectiveStats.of(costs).summary())
            print(f"       roofline: compute={rt.compute_s:.3e}s memory<={rt.memory_s:.3e}s "
                  f"coll={rt.collective_s:.3e}s -> {rt.bottleneck}-bound, "
                  f"useful={rt.flops_ratio:.2f}")
            if rank0 is not None:
                print(f"       rank 0 on the card: {rank0['step_s']:.3f}s, peak "
                      f"{rank0['peak_memory_bytes'] / 1e9:.2f} GB, temp {temp / 1e9:.2f} GB")
    except Exception as e:  # noqa: BLE001 - report, continue the sweep
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR]  {arch} x {shape_name} x {mesh_name}: {e}")
    return record


# ------------------------------------ cells with values, one process a rank
@dataclasses.dataclass(frozen=True)
class CellJob:
    """One production cell for :func:`run_world_cells`: ``make_cell`` of
    ``arch`` at ``cfg`` and ``shape`` on ``mesh`` (virtual device ids on
    named axes, whose size is the world's; ``fold`` axes one DeviceMesh
    dim), in ``mode`` (None: the policy's), under ``knobs``. Whole values
    come from ``values``, an .npz of them by ``Cell.place`` path, or when
    None from ``seed`` (``steps.seeded_values``, made on the rank's
    device). ``hold_to`` maps a label to a file of whole outputs by path
    ('out/...'; an .npz, or a dict saved with ``torch.save``) that every
    rank holds its gathered outputs to."""

    name: str
    arch: str
    cfg: Any
    shape: Any
    mesh: Any
    mode: str | None = None
    fold: tuple[str, ...] = ()
    knobs: Any = None
    values: str | None = None
    seed: int = 0
    hold_to: dict = dataclasses.field(default_factory=dict)


def job_values(job: CellJob, device):
    """``Cell.place``'s values of ``job`` on ``device``."""
    import numpy as np

    from repro_torch.launch import steps

    if job.values is None:
        return steps.seeded_values(job.seed, job.cfg.vocab_size, device)
    z = np.load(job.values)

    def make(path, like):
        v = np.array(z[path])
        return int(v) if path == "pos" else torch.from_numpy(v)

    return make


def outputs_by_path(out) -> dict:
    """A step's outputs as {path: tensor}, paths from 'out' (``Cell.place``'s
    naming: keys, fields and indices joined by '/')."""
    from repro_torch.launch import steps

    flat = {}
    steps._tree_at(lambda p, x: flat.__setitem__(p, x) if isinstance(x, torch.Tensor)
                   else None, "out", out)
    return flat


def one_process_outputs(job: CellJob, device) -> tuple[dict, float]:
    """``job``'s step in this one process on ``device``: the cell built on a
    fake world of the mesh's size (for its arguments and microbatches),
    run on whole plain tensors of the same values under the cell's
    settings with no mesh. Its outputs by path (the twin every rank's
    gathered outputs are held to) and the step's seconds."""
    from repro_torch.core import world
    from repro_torch.launch import knobs as knobs_mod
    from repro_torch.launch import steps

    knobs = job.knobs or knobs_mod.Knobs()
    with world.world("fake", int(job.mesh.device_ids.size)), knobs_mod.apply(knobs):
        mesh = world.on_world(job.mesh, "meta", device_type="cpu", fold=job.fold)
        cell = steps.make_cell(job.arch, job.cfg, job.shape, mesh, mode=job.mode)
    args = cell.whole(job_values(job, device), device)
    cuda = torch.device(device).type == "cuda"
    with knobs_mod.apply(knobs), steps.mesh_settings(job.cfg, job.shape, None,
                                                     mode=cell.plan.mode):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cell.step_fn(*args)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return {k: v.detach() for k, v in outputs_by_path(out).items()}, seconds


def _held(full: dict, path: str) -> dict:
    """{output path: [max |got - want|, max |want|]} against the whole
    outputs saved at ``path``."""
    import numpy as np

    want = np.load(path) if str(path).endswith(".npz") else torch.load(
        path, map_location="cpu", mmap=True)
    out = {}
    for p, got in full.items():
        w = want[p]
        w = (torch.from_numpy(np.array(w)) if not isinstance(w, torch.Tensor) else w
             ).to(got.device, torch.float64)
        if tuple(w.shape) != tuple(got.shape):
            raise ValueError(f"{p}: gathered {tuple(got.shape)}, held to {tuple(w.shape)}")
        out[p] = [float((got.detach().double() - w).abs().max()), float(w.abs().max())]
        del w
    return out


def _cell_on_rank(w, job: CellJob) -> dict:
    from repro_torch.core import world
    from repro_torch.kernels import ops
    from repro_torch.launch import knobs as knobs_mod
    from repro_torch.launch import steps

    mesh = w.place(job.mesh, fold=job.fold)
    with knobs_mod.apply(job.knobs or knobs_mod.Knobs()):
        cell = steps.make_cell(job.arch, job.cfg, job.shape, mesh, mode=job.mode)
        ops.reset_launch_counts()
        world.reset_staged()
        rec = cell.run(mesh.device, values=job_values(job, mesh.device))
        staged_step = world.staged_bytes()
        full = outputs_by_path(cell.gather(rec.pop("out")))
    row = dict(rec, mode=cell.plan.mode, n_micro=cell.n_micro,
               coords=list(mesh.dist.get_coordinate()), launches=ops.launch_counts(),
               staged_step=staged_step, staged=world.staged_bytes(),
               held={label: _held(full, path) for label, path in job.hold_to.items()})
    if job.shape.kind == "train":
        row["metrics"] = {k.split("/")[-1]: float(v) for k, v in full.items()
                          if k.startswith("out/1/")}
    return row


def _cells_rank(rank: int, n: int, address: str, out_dir: str, kind: str, device: str,
                share_card: bool, jobs: list) -> None:
    """One rank of a world of cells: each job's cell on this rank's bound
    device, its outputs gathered and held to the job's files; the report
    (a job's error in place of its row, the others still run) goes to
    ``out_dir/rank<r>.json``."""
    import os

    from repro_torch.core import world

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    if device == "cuda":
        from repro_torch.kernels.ref import no_tf32

        no_tf32()
    report = {}
    with world.world(kind, n, rank=rank, address=address, device_type=device,
                     share_card=share_card) as w:
        for job in jobs:
            try:
                report[job.name] = _cell_on_rank(w, job)
            except Exception as e:  # noqa: BLE001 - reported, the tests read it
                report[job.name] = {"error": f"{type(e).__name__}: {e}",
                                    "traceback": traceback.format_exc()[-3000:]}
            if device == "cuda":
                torch.cuda.empty_cache()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))


def run_world_cells(jobs, kind: str, device: str, *, share_card: bool = False,
                    timeout: float = 600.0) -> dict:
    """Run each :class:`CellJob` with one process per mesh rank (the cells'
    counterpart of ``apps/run.py::run_worlds``): one ``kind`` world per
    mesh size, spawned once, its cells run in turn. Each rank places the
    mesh (``World.place``: on CUDA the card its position's ``device_ids``
    entry names, or card 0 with ``share_card``), builds the cell with
    ``make_cell``, runs it once on its blocks of the whole values and
    gathers the outputs; it reports the step's wall, its peak memory,
    its staged bytes by collective (the step's and with the gather), the
    devices and shapes of its blocks, the kernels launched and each
    output's difference from every ``hold_to`` file. Returns ``{n: [rank
    reports]}``; raises ``world.WorldRefused`` before spawning a world
    the host cannot give and ``RuntimeError`` if a rank dies or the
    world outlives ``timeout`` seconds."""
    from repro_torch.core import world

    groups: dict[int, list] = {}
    for job in jobs:
        groups.setdefault(int(job.mesh.device_ids.size), []).append(job)
    for n in groups:
        world.check(kind, n, device, share_card=share_card)
    return {n: world.spawn_ranks(_cells_rank, n, (kind, device, share_card, group), timeout)
            for n, group in sorted(groups.items())}


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.knobs import Knobs
    from repro_torch.models.config import SHAPES

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (see repro_torch.configs)")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all' (train_4k, prefill_32k, "
                         "decode_32k, long_500k)")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape (the defaults of --arch and --shape)")
    ap.add_argument("--device", choices=("cuda", "meta"), default="cuda",
                    help="meta: count only, no card; cuda (default): count, "
                         "then run the step on the card (no fallback)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch of the card's run (default: the shape's global batch)")
    ap.add_argument("--baseline", action="store_true",
                    help="paper-faithful baseline knobs (scan WKV, no "
                         "shard_map SP attention, no microbatching)")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--mesh", default=None, choices=sorted(MESHES),
                    help="count the production meshes on a fake process group "
                         "(unset: one card)")
    ap.add_argument("--mode", default=None, choices=("tp", "fsdp"),
                    help="override the sharding-policy mode (with --mesh)")
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="disable sequence-parallel residual sharding (with --mesh)")
    args = ap.parse_args(argv)
    if args.mesh is None and (args.mode or args.no_seq_shard):
        print("ERROR: --mode and --no-seq-shard set a production mesh's sharding; "
              "pass --mesh single|multi|both", file=sys.stderr)
        return 2
    if args.mesh is not None and args.batch is not None:
        print("ERROR: --batch sets the one-card run; a production mesh runs each "
              "cell at its global batch", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda (the default) needs an NVIDIA GPU, and torch "
              "finds no CUDA card here; pass --device meta to count without one",
              file=sys.stderr)
        return 2

    knobs = (
        Knobs(wkv_impl="scan", sp_attention=False, microbatch=1)
        if args.baseline else Knobs(wkv_impl="chunked")
    )
    archs = ARCH_IDS if args.all or args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape == "all" else [args.shape]

    records = []
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            if args.mesh is None:
                records.append(run_cell(arch, shape, device=args.device,
                                        batch=args.batch, knobs=knobs))
            for mesh_name in MESHES.get(args.mesh, []):
                records.append(run_mesh_cell(arch, shape, mesh_name, device=args.device,
                                             mode=args.mode,
                                             seq_shard=not args.no_seq_shard,
                                             knobs=knobs))
            if args.device == "cuda":
                torch.cuda.empty_cache()
    ok = sum(r["status"] == "ok" for r in records)
    skip = sum(r["status"] == "skipped" for r in records)
    err = sum(r["status"] == "error" for r in records)
    print(f"\n=== dry-run: {ok} ok, {skip} skipped, {err} errors, "
          f"{time.time() - t0:.0f}s total ===")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
        print(f"wrote {args.out}")
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())
