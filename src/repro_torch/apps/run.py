"""End-to-end runner for the nine paper applications, on one card.

Runs every selected app through the full pipeline —

    dsl.parse  ->  Mapper  ->  translate.to_spmd  ->  commvolume

— and prints the paper's Table-style LoC and communication-volume summary.

    python -m repro_torch.apps.run --list
    python -m repro_torch.apps.run --app summa --procs 64
    python -m repro_torch.apps.run --all --execute           # + numerics
    python -m repro_torch.apps.run --all --execute --device cpu

``--execute`` additionally runs each app's SPMD program on a mesh of
virtual ranks (one device; the matmul and stencil bodies through the
hand-written kernels) and checks it against its single-device oracle.
``--device`` defaults to ``cuda``: without a card the command stops with
an error unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device the meshes live on (default: cuda; "
                         "there is no silent fallback to the CPU)")
    ap.add_argument("--list", action="store_true",
                    help="list registered applications")
    args = ap.parse_args(argv)

    if args.procs is not None and args.procs < 1:
        ap.error(f"--procs must be >= 1, got {args.procs}")

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

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda (the default) needs an NVIDIA GPU, and "
              "torch finds no CUDA card here; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2

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
