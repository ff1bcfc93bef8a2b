#!/usr/bin/env python3
"""Hill-climb steps on the production meshes: knobs -> recount -> record.

The port's counterpart of ``benchmarks/perf_iterations.py``: the same
three (arch x shape) cells on the 256-chip single mesh and the same
named knob steps, each counted by the port's production dry run
(``repro_torch.launch.dryrun.run_mesh_cell`` on the meta device: rank
(0, 0)'s share on a fake process group), one row a step with the
reference's keys. The roofline terms are at the machine model's rates,
as the reference's are.

    PYTHONPATH=src python3 tools/perf_iterations.py \\
        [--out results/perf_iterations_torch.json] [--layers N]

``--layers N`` cuts each cell's depth to N layers (a quick pass; full
depth by default). ``run()`` summarizes a recorded file (per cell, the
dominant roofline term of each step and the first step over the last).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

RESULTS_PATH = Path("results/perf_iterations_torch.json")


def experiments():
    from repro_torch.launch.knobs import Knobs

    base = dict(sp_attention=False, wkv_impl="scan", microbatch=1)
    return [
        # ---- cell 1: worst roofline fraction (memory term pathological)
        {
            "cell": ("rwkv6-3b", "train_4k", "single"),
            "steps": [
                ("baseline: per-step WKV scan", Knobs(**base)),
                ("chunked WKV (flash-linear-attention form)",
                 Knobs(**{**base, "wkv_impl": "chunked"})),
                ("chunked WKV + microbatch=2",
                 Knobs(**{**base, "wkv_impl": "chunked", "microbatch": 2})),
            ],
        },
        # ---- cell 2: most collective-bound (score-block resharding)
        {
            "cell": ("musicgen-medium", "train_4k", "single"),
            "steps": [
                ("baseline: partitioner-resharded attention", Knobs(**base)),
                ("bf16 params before gather (REFUTED: no change)",
                 Knobs(**{**base, "bf16_gather": True})),
                ("shard_map SP attention",
                 Knobs(**{**base, "sp_attention": True})),
                ("SP attention + microbatch=4",
                 Knobs(**{**base, "sp_attention": True, "microbatch": 4})),
            ],
        },
        # ---- cell 3: the paper's own technique (EP dispatch volume)
        {
            "cell": ("deepseek-v2-lite-16b", "train_4k", "single"),
            "steps": [
                ("baseline: capacity 1.25", Knobs(**base)),
                ("capacity 1.0 (a2a cut)",
                 Knobs(**{**base, "moe_capacity": 1.0})),
                ("+ shard_map SP attention",
                 Knobs(**{**base, "moe_capacity": 1.0,
                          "sp_attention": True})),
                ("+ microbatch=4 (policy)",
                 Knobs(**{**base, "moe_capacity": 1.0, "sp_attention": True,
                          "microbatch": 0})),
            ],
        },
    ]


def step_row(cell: tuple, name: str, knobs, *, layers: int | None = None) -> dict:
    """One step's row (the reference's keys): the cell counted under
    ``knobs``, at ``layers`` layers when given."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_mesh_cell

    arch, shape, mesh = cell
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=layers,
            first_dense_layers=min(cfg.first_dense_layers, layers - 1))
    rec = run_mesh_cell(arch, shape, mesh, knobs=knobs, verbose=False, cfg=cfg)
    rt = rec.get("roofline", {})
    temp = rec.get("memory_analysis", {}).get("temp_size_in_bytes")
    return {
        "cell": list(cell), "step": name, "status": rec["status"],
        "compute_s": rt.get("compute_s"), "memory_s": rt.get("memory_s"),
        "collective_s": rt.get("collective_s"), "bottleneck": rt.get("bottleneck"),
        "useful": rt.get("useful_flops_ratio"),
        "temp_gib": None if temp is None else temp / 2**30,
        "collective_bytes": rec.get("collective_bytes"), "error": rec.get("error"),
    }


def run(report=print, path: Path = RESULTS_PATH) -> dict:
    """Summarize a recorded file (per-cell best step), as the reference's
    ``run()``; raises ``FileNotFoundError`` when it is absent."""
    rows = json.loads(Path(path).read_text())
    ok_rows = [r for r in rows if r["status"] == "ok"]
    report(f"{'cell':45s} {'step':45s} {'dominant_s':>11s} {'bound':>10s}")
    cells: dict[tuple, list] = {}
    for r in ok_rows:
        cells.setdefault(tuple(r["cell"]), []).append(r)
    improvements = []
    for cell, steps in cells.items():
        dom = [max(s["compute_s"], s["memory_s"], s["collective_s"]) for s in steps]
        for s, d in zip(steps, dom):
            report(f"{'x'.join(cell):45s} {s['step'][:45]:45s} {d:11.3e} "
                   f"{s['bottleneck']:>10s}")
        if len(dom) > 1 and dom[-1] > 0:
            improvements.append(dom[0] / dom[-1])
    if improvements:
        report(f"\n{len(cells)} cells; baseline -> final dominant-term speedups: "
               + ", ".join(f"{x:.2f}x" for x in improvements))
    return {"cells": len(cells), "rows": len(ok_rows), "speedups": improvements}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(RESULTS_PATH))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each cell to this many layers (default: full depth)")
    args = ap.parse_args(argv)
    results = []
    for exp in experiments():
        print(f"\n### {' x '.join(exp['cell'])}")
        for name, knobs in exp["steps"]:
            row = step_row(exp["cell"], name, knobs, layers=args.layers)
            results.append(row)
            if row["status"] == "ok":
                print(f"  {name:45s} comp={row['compute_s']:.3e} mem={row['memory_s']:.3e} "
                      f"coll={row['collective_s']:.3e} [{row['bottleneck']}] "
                      f"useful={row['useful']:.2f}")
            else:
                print(f"  {name:45s} ERROR: {row['error']}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    print(f"\nwrote {args.out}")
    run(path=Path(args.out))
    return 1 if any(r["status"] != "ok" for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
