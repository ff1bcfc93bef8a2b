"""End-to-end runner for the nine paper applications, on one card.

Runs every selected app through the full pipeline —

    dsl.parse  ->  Mapper  ->  translate.to_spmd  ->  commvolume

— and prints the paper's Table-style LoC and communication-volume summary.

    python -m repro_torch.apps.run --list
    python -m repro_torch.apps.run --app summa --procs 64
    python -m repro_torch.apps.run --all --execute           # + numerics
    python -m repro_torch.apps.run --all --execute --device cpu
    python -m repro_torch.apps.run --all --tune              # autotuner
    python -m repro_torch.apps.run --all --tune --time --backend torch \\
        --procs 4096                                         # on the card
    python -m repro_torch.apps.run --all --simulate          # sim timeline

``--execute`` additionally runs each app's SPMD program on a mesh of
virtual ranks (one device; the matmul and stencil bodies through the
hand-written kernels) and checks it against its single-device oracle.
``--device`` defaults to ``cuda``: without a card the command stops with
an error unless ``--device cpu`` is given.

``--tune`` runs the mapper autotuner (``repro_torch.search``) over each
selected app's declared search space: candidates are scored with the
app's cost model, beam-pruned, evaluated through the vectorized batch
path, and the winning Mapple program + candidate leaderboard are
printed. The legacy hand-tuned volume pair is checked as a regression
oracle. The volume tune is host code. ``--tune --time`` swaps the
objective for the batched discrete-event simulator (predicted seconds
per step, every beam placement batch-priced); ``--backend torch`` prices
the beams on ``--device`` through the device-resident torch engine (its
dense congestion reduction through the hand-written ``segment_rowmax``
kernel on a card) instead of the NumPy reference, with the same winners
and <=1e-6-relative identical seconds; ``--backend numpy`` is host code.

``--pipeline``/``--no-pipeline`` (with ``--tune --time``) force the
streaming producer/consumer Phase 3 on or off (default: auto — stream
when the pricing engine is ``batched-torch``; identical numbers either
way). ``--cache-dir DIR`` persists placement prices under
``DIR/prices`` so re-tunes serve from disk.

``--simulate`` runs each selected app's mapped step through the
discrete-event simulator (``repro_torch.sim``) on the host: the plan's
device permutation becomes the exact tile->processor assignment, the
app's declared collective pattern expands into a wire schedule, and the
engine prints the resulting per-step timeline.

``--json PATH`` (with ``--tune`` or ``--simulate``) additionally writes
the machine-readable results.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch


def analyze(app, procs: int | None, device="cuda") -> dict:
    """One app through parse -> map -> translate -> commvolume."""
    from repro_torch.core.translate import to_spmd

    n = app.procs(procs)
    note = ""
    try:
        app.tile_grid(n)
    except ValueError:
        note = f"(procs {n} unusable; using default {app.default_procs})"
        n = app.default_procs
    program = app.program(n)
    plan = to_spmd(program, app.name, app.tile_grid(n), app.axis_names,
                   device=device)
    perm = plan.meta["device_permutation"]
    return {
        "app": app.name,
        "kind": app.kind,
        "procs": n,
        "machine": app.machine_shape(n),
        "grid": plan.meta["tile_grid"],
        "mapper": plan.meta["mapper"],
        "bijective": len(set(perm)) == len(perm),
        "mapple_loc": program.loc(),
        "lowlevel_loc": app.lowlevel_loc(),
        "comm_volume": app.comm_volume(n),
        "step_flops": app.step_flops(n),
        "backpressure": plan.backpressure,
        "memory_kinds": plan.memory_kinds,
        "donate": plan.donate,
        "operands": tuple(sorted(plan.in_specs)),
        "mapper_ir": plan.meta["mapper_ir"],
        "note": note,
    }


def report_table(rows, report=print) -> None:
    report(
        f"{'app':10s} {'procs':>5s} {'grid':>12s} {'mapple':>7s} "
        f"{'low-level':>10s} {'ratio':>6s} {'comm(elem)':>11s} "
        f"{'bijective':>9s}"
    )
    for r in rows:
        grid = "x".join(str(g) for g in r["grid"])
        if r["lowlevel_loc"]:
            raw_loc = f"{r['lowlevel_loc']:10d}"
            ratio = f"{r['lowlevel_loc'] / max(r['mapple_loc'], 1):6.1f}"
        else:                       # fixture unavailable (installed pkg)
            raw_loc, ratio = f"{'-':>10s}", f"{'-':>6s}"
        report(
            f"{r['app']:10s} {r['procs']:5d} {grid:>12s} "
            f"{r['mapple_loc']:7d} {raw_loc} {ratio} "
            f"{r['comm_volume']:11.3g} {str(r['bijective']):>9s} {r['note']}"
        )
    avg_m = sum(r["mapple_loc"] for r in rows) / len(rows)
    avg_r = sum(r["lowlevel_loc"] for r in rows) / len(rows)
    if avg_r:
        report(
            f"{'AVG':10s} {'':5s} {'':>12s} {avg_m:7.1f} {avg_r:10.1f} "
            f"{avg_r / avg_m:6.1f}"
        )


def execute(selection, rows, device, report=print) -> int:
    """Run each app's SPMD program against its oracle; nonzero on failure."""
    from repro_torch.apps import validate

    report(f"\n{'app':10s} {'procs':>5s} {'max_err':>10s} {'ok':>4s}")
    failed = []
    for app, row in zip(selection, rows):
        res = validate.run(app, row["procs"], device=device)
        report(f"{app.name:10s} {row['procs']:5d} "
               f"{res['max_err']:10.2e} {str(res['ok']):>4s}")
        if not res["ok"]:
            failed.append(app.name)
    if failed:
        print(f"ERROR: numeric check failed: {failed}", file=sys.stderr)
        return 1
    return 0


def _finish(procs: int | None, json_rows: list, failures: list[str],
            json_path: str | None, report) -> int:
    """Shared mode epilogue: JSON envelope + failure report + exit code."""
    if json_path:
        import json
        from pathlib import Path

        Path(json_path).write_text(json.dumps(
            {"procs_requested": procs, "apps": json_rows}, indent=2) + "\n")
        report(f"wrote {json_path}")
    if failures:
        for f in failures:
            print(f"ERROR: {f}", file=sys.stderr)
        return 1
    return 0


def tune(selection, procs: int | None, report=print,
         json_path: str | None = None, time_domain: bool = False,
         backend: str = "numpy", pipeline: bool | None = None,
         cache_dir: str | None = None, device: str = "cuda") -> int:
    """Run the autotuner over the selected apps; nonzero on any failure.

    ``time_domain`` swaps each app's volume objective for the batched
    simulator (``repro_torch.sim.cost.time_tuned_app``): candidates are
    scored in predicted seconds and every surviving beam variant's actual
    placement is batch-priced (the ``placed_s`` leaderboard column).
    ``backend`` picks the pricing engine for the time objective —
    ``"numpy"`` (the reference, host code) or ``"torch"`` (the
    device-resident twin on ``device``, <=1e-6-relative identical).
    ``pipeline`` forces Phase 3's streaming producer/consumer shape on
    (True) or off (False; None auto-selects it for the torch engine), and
    ``cache_dir`` points the persistent price cache at a directory so
    repeat tunes skip pricing across processes.
    """
    import time

    from repro_torch.search.tuner import (
        feasible_procs,
        nearest_feasible_procs,
        report_lines,
        tune_app,
    )

    price_cache = None
    if cache_dir is not None:
        from repro_torch.sim.price_cache import PriceCache

        price_cache = PriceCache(os.path.join(cache_dir, "prices"))
        report(f"price cache: {price_cache.root}")
    if time_domain and backend == "torch":
        from repro_torch.sim.torch_backend import platform_info

        info = platform_info(device)
        if not info["available"]:
            raise RuntimeError(
                f"--backend torch was asked to price on {device!r}, and "
                f"torch finds no CUDA card here")
        report(f"torch backend: platform={info['platform']} "
               f"devices={info['device_count']}x[{','.join(info['devices'])}] "
               f"segment_rowmax={'cuda kernel' if info['kernel'] else 'plain'}")

    failures = []
    tuned = 0
    json_rows = []
    t0 = time.perf_counter()
    for app in selection:
        if app.search_space is None:
            report(f"[{app.name}] no search space declared; skipping")
            continue
        if procs is not None:
            # Validate the requested scale up front against the cheap
            # volume space — a count that factors into no feasible tile
            # grid would otherwise surface as an opaque failure deep
            # inside the search.
            n = app.procs(procs)
            if not feasible_procs(app.search_space, n):
                near = nearest_feasible_procs(app.search_space, n)
                hint = (f" (nearest valid: {', '.join(map(str, near))})"
                        if near else "")
                failures.append(
                    f"{app.name}: --procs {n} does not factor into a "
                    f"feasible tile grid for this app{hint}"
                )
                report(f"[{app.name}] --procs {n} infeasible; "
                       f"skipping{hint}")
                continue
        if time_domain:
            if getattr(app, "collective", None) is None:
                report(f"[{app.name}] no collective pattern declared; "
                       f"skipping")
                continue
            from repro_torch.sim.cost import time_tuned_app

            engine = "batched-torch" if backend == "torch" else "batched"
            app = time_tuned_app(app, engine=engine, device=device,
                                 cache=price_cache)
        rep = tune_app(app, procs, pipeline=pipeline)
        tuned += 1
        for line in report_lines(rep):
            report(line)
        report("")
        if json_path:
            json_rows.append({
                **rep.summary(),
                "best_source": rep.best_source,
                "leaderboard": [s.row() for s in rep.leaderboard],
            })
        if not rep.verified:
            failures.append(f"{app.name}: rendered DSL diverged from the IR")
        if not rep.oracle_ok:
            if rep.best.volume > rep.oracle[1] * (1 + 1e-9):
                failures.append(
                    f"{app.name}: tuner failed to rediscover the hand-tuned "
                    f"volume (best {rep.best.volume:.6g} vs oracle "
                    f"{rep.oracle[1]:.6g})"
                )
            else:
                failures.append(
                    f"{app.name}: default candidate volume "
                    f"{rep.default.volume:.6g} disagrees with the oracle "
                    f"default {rep.oracle[0]:.6g}"
                )
    report(f"tuned {tuned} of {len(selection)} app(s) in "
           f"{time.perf_counter() - t0:.2f}s")
    return _finish(procs, json_rows, failures, json_path, report)


def simulate(selection, procs: int | None, report=print,
             json_path: str | None = None) -> int:
    """Run the discrete-event simulator over the selected apps."""
    from repro_torch.sim.cost import simulate_app

    rows = []
    failures = []
    report(
        f"{'app':10s} {'procs':>5s} {'grid':>10s} {'pattern':>16s} "
        f"{'bp':>3s} {'compute_s':>10s} {'comm_s':>10s} {'step_s':>10s} "
        f"{'flat_s':>10s} {'xnode%':>7s} {'inflt':>5s}"
    )
    for app in selection:
        if getattr(app, "collective", None) is None:
            report(f"[{app.name}] no collective pattern declared; skipping")
            continue
        try:
            rep = simulate_app(app, procs)
        except ValueError as e:
            failures.append(f"{app.name}: {e}")
            continue
        rows.append(rep)
        grid = "x".join(str(g) for g in rep.grid)
        report(
            f"{rep.app:10s} {rep.procs:5d} {grid:>10s} {rep.pattern:>16s} "
            f"{rep.backpressure:3d} {rep.compute_s:10.3e} {rep.comm_s:10.3e} "
            f"{rep.step_time_s:10.3e} {rep.flat_step_time_s:10.3e} "
            f"{rep.inter_node_bytes_frac * 100:6.1f}% {rep.max_in_flight:5d}"
            + (f"  {rep.note}" if rep.note else "")
        )
    max_lines = 24
    for rep in rows:
        report(f"\n[{rep.app}] step timeline "
               f"({rep.n_phases} comm phases/step, first step shown):")
        segs = [s for s in rep.timeline.segments
                if s.step == 0 and s.label != "step_done"]
        for seg in segs[:max_lines]:
            report(f"  {seg.resource:8s} {seg.start * 1e3:9.4f}ms "
                   f"-> {seg.end * 1e3:9.4f}ms  {seg.label}")
        if len(segs) > max_lines:
            report(f"  ... {len(segs) - max_lines} more segments "
                   f"(--json for the full timeline)")
    return _finish(procs, [r.summary() for r in rows], failures,
                   json_path, report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.apps.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--app", default=None, help="one application by name")
    ap.add_argument("--all", action="store_true", help="all nine paper apps")
    ap.add_argument("--procs", type=int, default=None,
                    help="processor count (default: per-app paper scale)")
    ap.add_argument("--execute", action="store_true",
                    help="also run each app on a mesh of virtual ranks vs "
                         "its single-device oracle")
    ap.add_argument("--show-ir", action="store_true",
                    help="print each mapper's recorded transformation IR "
                         "(the inspectable ProcSpace op programs)")
    ap.add_argument("--tune", action="store_true",
                    help="run the mapper autotuner over each app's search "
                         "space and print the winning program + leaderboard")
    ap.add_argument("--time", action="store_true",
                    help="with --tune: search on batched-simulator seconds "
                         "instead of communication volume (placements are "
                         "batch-priced; works at 4096 procs)")
    ap.add_argument("--backend", choices=("numpy", "torch"), default="numpy",
                    help="with --tune --time: pricing engine — 'numpy' "
                         "(the host reference) or 'torch' (device-resident "
                         "on --device, <=1e-6-relative identical)")
    ap.add_argument("--pipeline", dest="pipeline", action="store_true",
                    default=None,
                    help="with --tune --time: stream Phase 3 (host "
                         "candidate expansion overlaps device pricing; "
                         "default: auto — on for --backend torch)")
    ap.add_argument("--no-pipeline", dest="pipeline", action="store_false",
                    help="with --tune --time: force the strict-barrier "
                         "Phase 3 (expand everything, then one packed "
                         "pricing sweep)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="with --tune --time: persistent cache directory "
                         "— priced placements (DIR/prices) are reused "
                         "across processes")
    ap.add_argument("--simulate", action="store_true",
                    help="run each app's mapped step through the "
                         "discrete-event simulator and print the timeline")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="with --tune/--simulate: write machine-readable "
                         "results (leaderboard + winner IR / timelines)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of --execute's meshes and of --backend "
                         "torch's pricing (default: cuda; there is no "
                         "silent fallback to the CPU)")
    ap.add_argument("--list", action="store_true",
                    help="list registered applications")
    args = ap.parse_args(argv)

    if args.procs is not None and args.procs < 1:
        ap.error(f"--procs must be >= 1, got {args.procs}")
    if args.tune and (args.execute or args.show_ir or args.simulate):
        ap.error("--tune is a separate mode; run it without "
                 "--execute/--show-ir/--simulate")
    if args.time and not args.tune:
        ap.error("--time requires --tune")
    if args.backend != "numpy" and not args.time:
        ap.error("--backend requires --tune --time")
    if args.pipeline is not None and not args.time:
        ap.error("--pipeline/--no-pipeline requires --tune --time")
    if args.cache_dir is not None and not args.time:
        ap.error("--cache-dir requires --tune --time")
    if args.simulate and (args.execute or args.show_ir):
        ap.error("--simulate is a separate mode; run it without "
                 "--execute/--show-ir")
    if args.json and not (args.tune or args.simulate):
        ap.error("--json requires --tune or --simulate")

    from repro_torch import apps

    if args.list:
        for app in apps.iter_apps():
            print(f"{app.name:10s} [{app.kind}/{app.pattern}] "
                  f"{app.description}")
        return 0

    if args.app:
        try:
            selection = [apps.get(args.app)]
        except KeyError:
            ap.error(f"unknown app {args.app!r}; known: "
                     f"{', '.join(sorted(apps.names()))}")
    elif args.all:
        selection = list(apps.iter_apps())
    else:
        ap.error("pass --app NAME, --all, or --list")

    on_card = args.execute or args.backend == "torch"
    if on_card and args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda (the default) needs an NVIDIA GPU, and "
              "torch finds no CUDA card here; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2

    if args.tune:
        return tune(selection, args.procs, json_path=args.json,
                    time_domain=args.time, backend=args.backend,
                    pipeline=args.pipeline, cache_dir=args.cache_dir,
                    device=args.device)
    if args.simulate:
        return simulate(selection, args.procs, json_path=args.json)

    rows = [analyze(app, args.procs, args.device) for app in selection]
    report_table(rows)

    if args.show_ir:
        print("\nmapper transformation IR (root shape + recorded ops):")
        for r in rows:
            print(f"[{r['app']}] operands={','.join(r['operands'])}")
            for line in r["mapper_ir"].splitlines():
                print(f"  {line}")

    if not all(r["bijective"] for r in rows):
        print("ERROR: non-bijective mapping produced", file=sys.stderr)
        return 1

    if args.execute:
        return execute(selection, rows, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
