#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

1. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it (matmul fp32 rtol=atol=1e-4 and bf16 2e-2, the
   JAX package's kernel tolerances; stencil fp32 1e-4; segment_rowmax
   float64 1e-12 and float32 1e-4), and times both, with one library call
   beside each as a yardstick where one PyTorch call computes the same
   function;
3. drives the execute path: all nine paper apps through ``repro_torch.apps``
   at the registry's own problem sizes and default processor counts, each
   checked against its single-device oracle on the card, with the kernels'
   launch counters set to 0 just before and read just after (after one
   uncounted pass at the small validation sizes, so that the per-app times
   are not first-call times);
4. sweeps the pricer: for each app, its most balanced grid at 4096
   processors and 256 seeded random placements, priced by the torch engine
   on the card with the segment_rowmax kernel, against the NumPy engine (8
   rows, 1e-6 relative) and the engine's plain reduction (all rows, 1e-12);
5. drives the tune path: the time-domain tuner over all nine apps at 4096
   processors through ``repro_torch.apps.run.tune``, once on the torch
   engine on the card (launch counters set to 0 just before, read just
   after) and once on the NumPy engine; the winners must be the same and
   the placed seconds agree within 1e-6 relative;
6. prints one JSON ``kernels`` line (matmul and stencil launches from the
   execute path, segment_rowmax launches from the tune path), the card's
   name and power limit, and last ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line. Without a CUDA card,
or without the rest of the repository beside it, it fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks: dense fp32 and fp64 on the CUDA cores, dense
# bf16 on the tensor cores, HBM3 bandwidth.
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# segment_rowmax: float64 is the pricer's default and sums at most a few
# values per segment (1e-12); float32 takes the repo's fp32 tolerance.
SR_TOL = {"float64": dict(rtol=1e-12, atol=1e-12),
          "float32": dict(rtol=1e-4, atol=1e-4)}
# The pricer's scale, its placements per app, and its parity limits: the
# NumPy engine (sim_eval's 1e-6 gate) and the engine's plain reduction.
PRICER_PROCS = 4096
PRICER_ROWS = 256
PRICER_NUMPY_ROWS = 8
PRICER_RTOL = 1e-6
KERNEL_VS_PLAIN_RTOL = 1e-12
SCATTER_APP = "summa"      # the largest schedule (516096 transfers)
KERNELS = {
    "matmul": {"source": "src/repro_torch/kernels/csrc/matmul.cu",
               "replaces": "src/repro/kernels/matmul.py:39"},
    "stencil": {"source": "src/repro_torch/kernels/csrc/stencil.cu",
                "replaces": "src/repro/kernels/stencil.py:36"},
    "segment_rowmax": {"source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
                       "replaces": "src/repro/kernels/segment_reduce.py:52"},
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def app_shapes():
    """Block shapes the apps hand the kernels at their default procs."""
    from repro_torch import apps
    from repro_torch.apps import definitions

    p = definitions.MATMUL_PROBLEM
    mm = []
    for app in apps.iter_apps(kind=apps.MATMUL):
        g = app.tile_grid(app.default_procs)
        batch = 1
        for s in g:
            batch *= s
        if len(g) == 2 or app.name == "solomonik":   # blocks over (x, y)
            shape = (batch, p.m // g[0], p.k // g[1], p.n // g[1])
        else:                              # johnson, cosma: A (x, z), B (z, y)
            shape = (batch, p.m // g[0], p.k // g[2], p.n // g[1])
        if shape not in mm:
            mm.append(shape)
    st = apps.get("stencil")
    gx, gy = st.tile_grid(st.default_procs)
    nx, ny = definitions.STENCIL_LENGTHS
    return mm, (gx * gy, nx // gx + 2, ny // gy + 2), (nx, ny)


def check_close(name: str, out, expect, dtype: str) -> float:
    import torch

    err = float((out.float() - expect.float()).abs().max())
    if not torch.allclose(out.float(), expect.float(), **TOL[dtype]):
        fail(f"{name} disagrees with its plain version: max |diff| {err:.3e} "
             f"beyond rtol/atol {TOL[dtype]}")
    return err


def parity_and_timing(mm_shapes, stencil_block, stencil_field) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil as st_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    # ---- matmul: every app block shape in fp32 and bf16, plus a ragged one.
    cases = [(s, dt) for s in mm_shapes for dt in ("float32", "bfloat16")]
    cases += [((3, 1000, 777, 513), "float32"), ((3, 1000, 777, 513), "bfloat16")]
    for (b, m, k, n), dt in cases:
        dtype = getattr(torch, dt)
        a = torch.randn((b, m, k), generator=gen, device="cuda").to(dtype)
        w = torch.randn((b, k, n), generator=gen, device="cuda").to(dtype)
        err = check_close(f"matmul {dt} {(b, m, k, n)}",
                          mm_mod.matmul_cuda(a, w), ref.matmul(a, w), dt)
        print(f"parity matmul {dt:8s} batch={b} {m}x{k}x{n}: "
              f"max_abs_err={err:.3e}")
        if dt != "float32" or (b, m, k, n) not in mm_shapes:
            continue
        ref.no_tf32()
        ms = time_ms(lambda: mm_mod.matmul_cuda(a, w), reps=10)
        plain = time_ms(lambda: ref.matmul(a, w), reps=10)
        lib = time_ms(lambda: torch.matmul(a, w), reps=10)
        print(f"time   matmul {dt:8s} batch={b} {m}x{k}x{n}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, torch.matmul {lib:.4f} ms")
        if (b, m, k, n) != mm_shapes[0]:
            continue
        bnd, by = bound_ms(2.0 * b * m * n * k, 4.0 * b * (m * k + k * n + m * n), dt)
        rows["matmul"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                          "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
                          "shape": [b, m, k, n], "dtype": dt}

    # ---- stencil: the edge-replicate step on the app's field, and the
    # interior sweep on the app's halo-padded rank blocks (timed).
    field = torch.randn(stencil_field, generator=gen, device="cuda")
    err_step = check_close("stencil step", st_mod.stencil_cuda(field, interior=False),
                           ref.stencil(field), "float32")
    print(f"parity stencil step {stencil_field}: max_abs_err={err_step:.3e}")
    blocks = torch.randn(stencil_block, generator=gen, device="cuda")
    err = check_close("stencil interior", st_mod.stencil_cuda(blocks, interior=True),
                      ref.stencil_interior(blocks), "float32")
    print(f"parity stencil interior {stencil_block}: max_abs_err={err:.3e}")
    weight = torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2], [0.0, 0.2, 0.0]],
                          device="cuda").reshape(1, 1, 3, 3)
    conv_in = blocks.unsqueeze(1)
    ms = time_ms(lambda: st_mod.stencil_cuda(blocks, interior=True), reps=500)
    plain = time_ms(lambda: ref.stencil_interior(blocks), reps=500)
    lib = time_ms(lambda: F.conv2d(conv_in, weight), reps=500)
    b, h, w = stencil_block
    out_elems = b * (h - 2) * (w - 2)
    bnd, by = bound_ms(5.0 * out_elems, 4.0 * (b * h * w + out_elems), "float32")
    rows["stencil"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bnd, "bound_by": by,
                       "max_abs_err": max(err, err_step),
                       "shape": list(stencil_block), "dtype": "float32"}
    return rows


def apps_phase() -> dict[str, int]:
    """The main path: all nine apps at the registry's sizes, kernels on.

    A pass at the small validation sizes comes first, uncounted, so that
    the counted pass does not pay for first-call set-up (lazy loading of
    PyTorch's kernels). ``first ms`` is each app's first run at its full
    size; the steady-state times come from an uncounted pass after it.
    """
    from repro_torch import apps
    from repro_torch.apps import validate
    from repro_torch.kernels import ops

    for app in apps.iter_apps():
        if not validate.run(app, device="cuda")["ok"]:
            fail(f"{app.name} out of tolerance at the validation size")
    print(f"{'app':10s} {'procs':>5s} {'grid':>8s} {'max_err':>10s} "
          f"{'rel_err':>10s} {'first ms':>10s} {'matmul':>6s} {'stencil':>7s} ok")
    ops.reset_launch_counts()
    failures = []
    for app in apps.iter_apps():
        before = ops.launch_counts()
        res = validate.run(app, device="cuda", full=True)
        after = ops.launch_counts()
        raised = {k: after[k] - before[k] for k in after}
        grid = "x".join(str(g) for g in app.tile_grid(app.default_procs))
        rel = f"{res['rel_err']:10.3e}" if "rel_err" in res else f"{'-':>10s}"
        print(f"{app.name:10s} {app.default_procs:5d} {grid:>8s} "
              f"{res['max_err']:10.3e} {rel} {res['ms'][0]:10.3f} "
              f"{raised['matmul']:6d} {raised['stencil']:7d} {res['ok']}")
        if not res["ok"]:
            failures.append(f"{app.name} out of tolerance ({res})")
        if app.kind == apps.MATMUL and raised["matmul"] == 0:
            failures.append(f"{app.name} never launched the matmul kernel")
        if app.name == "stencil" and raised["stencil"] == 0:
            failures.append("stencil never launched the stencil kernel")
    counts = ops.launch_counts()
    if failures:
        fail("; ".join(failures))
    return counts


def steady_times(repeats: int = 6) -> None:
    """Per-app wall time after the first full-size run (uncounted): median,
    min and max of runs 2..``repeats`` on the same inputs."""
    import statistics

    from repro_torch import apps
    from repro_torch.apps import validate

    print(f"{'app':10s} {'median ms':>10s} {'min ms':>10s} {'max ms':>10s} "
          f"(runs 2..{repeats} of {repeats})")
    for app in apps.iter_apps():
        res = validate.run(app, device="cuda", full=True, repeats=repeats)
        if not res["ok"]:
            fail(f"{app.name} out of tolerance in the timing pass ({res})")
        ms = res["ms"][1:]
        print(f"{app.name:10s} {statistics.median(ms):10.3f} {min(ms):10.3f} "
              f"{max(ms):10.3f}")


def segment_rowmax_phase() -> dict:
    """segment_rowmax against its plain version at the pricer's table
    shapes (2048 x 4096 and 1536 x 4096 at 4096 procs) and two ragged
    ones, then timed at 2048 x 4096 float64 for seg 1 and 4."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = [((r, c), seg, dt) for (r, c) in ((2048, 4096), (1536, 4096))
             for seg in (1, 4) for dt in ("float64", "float32")]
    cases += [((1000, 780), 4, dt) for dt in ("float64", "float32")]
    cases += [((7, 5), 1, dt) for dt in ("float64", "float32")]
    errs, tables = {}, {}
    for shape, seg, dt in cases:
        vals = torch.rand(shape, generator=gen, device="cuda",
                          dtype=getattr(torch, dt))
        out = sr_mod.segment_rowmax_cuda(vals, seg)
        expect = ref.segment_rowmax(vals, seg)
        torch.cuda.synchronize()
        err = float((out - expect).abs().max())
        if out.shape != expect.shape or not torch.allclose(out, expect, **SR_TOL[dt]):
            fail(f"segment_rowmax {dt} {shape} seg={seg} disagrees with its "
                 f"plain version: max |diff| {err:.3e} beyond {SR_TOL[dt]}")
        print(f"parity segment_rowmax {dt:8s} {shape[0]}x{shape[1]} seg={seg}: "
              f"max_abs_err={err:.3e}")
        errs[dt] = max(errs.get(dt, 0.0), err)
        if shape == (2048, 4096) and dt == "float64":
            tables[seg] = vals

    timed = {}
    for seg, vals in tables.items():
        rows, cols = vals.shape
        ms = time_ms(lambda: sr_mod.segment_rowmax_cuda(vals, seg), reps=500)
        plain = time_ms(lambda: ref.segment_rowmax(vals, seg), reps=500)
        # seg 1 is a row max, torch.amax; no single PyTorch call sums
        # segments and takes their max.
        lib = (time_ms(lambda: torch.amax(vals, 1), reps=500) if seg == 1
               else None)
        bnd, by = bound_ms(float(rows * cols), 8.0 * (rows * cols + rows),
                           "float64")
        timed[seg] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": bnd, "bound_by": by}
        print(f"time   segment_rowmax float64 {rows}x{cols} seg={seg}: kernel "
              f"{ms:.5f} ms, plain {plain:.5f} ms, bound {bnd:.5f} ms ({by}), "
              + (f"torch.amax {lib:.5f} ms" if lib is not None
                 else "no single PyTorch call computes it"))
    return {"segment_rowmax": {
        **timed[1], "max_abs_err": max(errs.values()),
        "max_abs_err_by_dtype": errs, "shape": [2048, 4096, 1],
        "dtype": "float64", "seg4": timed[4]}}


def _balanced_grid(model, app, procs: int):
    """The most balanced grid of ``app`` at ``procs`` that the time model
    accepts (minimal aspect ratio; the shape a tuner shortlists)."""
    best = None
    for grid in app.search_space.grids(procs):
        try:
            model._validate(grid)
        except ValueError:
            continue
        key = (max(grid) / min(grid), grid)
        if best is None or key < best[0]:
            best = (key, grid)
    return None if best is None else best[1]


def _max_rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b))) if a.size else 0.0


def pricer_phase() -> None:
    """The torch pricing engine on the card against the NumPy engine and
    against its own plain reduction, at 4096 processors."""
    import numpy as np

    from repro_torch import apps
    from repro_torch.kernels import ops
    from repro_torch.sim.cost import time_search_space
    from repro_torch.sim.torch_backend import _export_for, to_torch

    print(f"{'app':10s} {'grid':>9s} {'mode':>6s} {'table':>10s} {'rel_np':>9s} "
          f"{'rel_plain':>9s} {'launches':>8s} {'numpy ms':>9s} {'torch ms':>9s} "
          f"{'plain ms':>9s}")
    failures = []
    for app in apps.iter_apps():
        space = time_search_space(app)
        model = space.cost_model(PRICER_PROCS, dict(space.default_options))
        grid = _balanced_grid(model, app, PRICER_PROCS)
        if grid is None:
            failures.append(f"{app.name} has no simulable grid at {PRICER_PROCS}")
            continue
        rng = np.random.default_rng(7)
        stack = np.stack([rng.permutation(PRICER_PROCS) for _ in range(PRICER_ROWS)])
        eng = model.batch(grid)
        t0 = time.perf_counter()
        want = eng.step_times(stack[:PRICER_NUMPY_ROWS])
        np_ms = (time.perf_counter() - t0) * 1e3
        kern = to_torch(eng, device="cuda")
        plain_eng = to_torch(eng, device="cuda", use_kernel=False)
        exp = _export_for(eng.schedule, eng.topology)
        chunk = min(exp.chunk(exp.mode), PRICER_ROWS)
        ops.reset_launch_counts()
        got = kern.step_times(stack)
        launches = ops.launch_counts()["segment_rowmax"]
        plain = plain_eng.step_times(stack)

        def best_ms(engine):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                engine.step_times(stack)
                best = min(best, time.perf_counter() - t0)
            return best * 1e3

        t_kern, t_plain = best_ms(kern), best_ms(plain_eng)
        rel_np = _max_rel(got[:PRICER_NUMPY_ROWS], want)
        rel_plain = _max_rel(got, plain)
        table = f"{chunk * exp.u}x{exp.ntiles}"
        g = "x".join(map(str, grid))
        print(f"{app.name:10s} {g:>9s} {exp.mode:>6s} {table:>10s} {rel_np:9.2e} "
              f"{rel_plain:9.2e} {launches:8d} {np_ms:9.2f} {t_kern:9.2f} "
              f"{t_plain:9.2f}")
        if not (np.isfinite(got).all() and got.shape == (PRICER_ROWS,)):
            failures.append(f"{app.name}: prices not finite of shape ({PRICER_ROWS},)")
        if rel_np > PRICER_RTOL:
            failures.append(f"{app.name}: torch vs NumPy engine {rel_np:.2e} > "
                            f"{PRICER_RTOL}")
        if rel_plain > KERNEL_VS_PLAIN_RTOL:
            failures.append(f"{app.name}: kernel vs plain reduction {rel_plain:.2e} "
                            f"> {KERNEL_VS_PLAIN_RTOL}")
        if exp.mode == "dense" and launches == 0:
            failures.append(f"{app.name}: dense schedule never launched "
                            f"segment_rowmax")
        if app.name == SCATTER_APP:
            failures += scatter_check(eng, kern, rng)
    if failures:
        fail("; ".join(failures))


def scatter_check(eng, kern, rng) -> list[str]:
    """Non-bijective rows take the scatter formulation (``index_add_``,
    atomic on the card): parity with the NumPy engine, and whether two
    runs agree bit for bit (reported; atomics may reorder the sums)."""
    import numpy as np

    stack = rng.integers(0, PRICER_PROCS, size=(PRICER_NUMPY_ROWS, PRICER_PROCS))
    want = eng.step_times(stack)
    first, second = kern.step_times(stack), kern.step_times(stack)
    rel = _max_rel(first, want)
    print(f"scatter {SCATTER_APP}: {PRICER_NUMPY_ROWS} non-bijective rows, "
          f"rel_np {rel:.2e}, two runs bit-identical: "
          f"{bool(np.array_equal(first, second))} (max rel diff "
          f"{_max_rel(first, second):.2e})")
    return ([] if rel <= PRICER_RTOL else
            [f"scatter pricing vs NumPy engine {rel:.2e} > {PRICER_RTOL}"])


def tune_phase() -> int:
    """The tune path: ``apps.run.tune`` over the nine apps at 4096 procs,
    time domain, on the torch engine on the card (counted) and on the
    NumPy engine, each from cold schedule caches; same winners, placed
    seconds within 1e-6 relative. Returns segment_rowmax's launches in
    the torch run."""
    from repro_torch import apps
    from repro_torch.apps import run as runner
    from repro_torch.kernels import ops
    from repro_torch.sim.collectives import clear_caches

    selection = list(apps.iter_apps())
    results, walls = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        for backend in ("torch", "numpy"):
            path = str(Path(tmp) / f"{backend}.json")
            clear_caches()        # both tunes build their schedules cold
            if backend == "torch":
                ops.reset_launch_counts()
            t0 = time.perf_counter()
            rc = runner.tune(selection, PRICER_PROCS, report=lambda line: None,
                             json_path=path, time_domain=True, backend=backend,
                             device="cuda")
            walls[backend] = time.perf_counter() - t0
            if backend == "torch":
                launches = ops.launch_counts()["segment_rowmax"]
            if rc != 0:
                fail(f"the {backend} tune at {PRICER_PROCS} procs exited {rc}")
            results[backend] = {row["app"]: row for row in
                                json.loads(Path(path).read_text())["apps"]}
    failures = []
    print(f"{'app':10s} {'winner (torch)':34s} {'placed_s':>12s} {'rel':>9s} same")
    for name, row in results["numpy"].items():
        mine = results["torch"].get(name)
        if mine is None:
            failures.append(f"{name}: not tuned on the torch engine")
            continue
        same = mine["best"]["candidate"] == row["best"]["candidate"]
        pairs = [(a["placed_cost"], b["placed_cost"])
                 for a, b in zip(mine["leaderboard"], row["leaderboard"])
                 if a["placed_cost"] is not None and b["placed_cost"] is not None]
        rel = _max_rel([a for a, _ in pairs], [b for _, b in pairs])
        print(f"{name:10s} {mine['best']['candidate']:34s} "
              f"{mine['best']['placed_cost']:12.6e} {rel:9.2e} {same}")
        if not same:
            failures.append(f"{name}: winner {mine['best']['candidate']} on torch, "
                            f"{row['best']['candidate']} on NumPy")
        if rel > PRICER_RTOL or len(mine["leaderboard"]) != len(row["leaderboard"]):
            failures.append(f"{name}: placed seconds differ by {rel:.2e} (or the "
                            f"leaderboards differ in length)")
    print(f"tune wall: torch {walls['torch']:.2f} s, numpy {walls['numpy']:.2f} s; "
          f"segment_rowmax launches in the torch tune: {launches}")
    if launches == 0:
        failures.append("the torch tune never launched segment_rowmax")
    if failures:
        fail("; ".join(failures))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA card; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    from repro_torch.kernels import build, ref

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    ref.no_tf32()

    t0 = time.perf_counter()
    lib = build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.seconds:.2f} s) -> {lib.path.relative_to(ROOT)}")
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    mm_shapes, stencil_block, stencil_field = app_shapes()
    rows = parity_and_timing(mm_shapes, stencil_block, stencil_field)
    rows.update(segment_rowmax_phase())
    counts = apps_phase()
    steady_times()
    pricer_phase()
    counts["segment_rowmax"] = tune_phase()

    kernels = []
    for name, row in rows.items():
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": counts[name], **row,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
