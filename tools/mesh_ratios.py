#!/usr/bin/env python3
"""The port's production-mesh dry run over the reference's, cell by cell.

    python3 tools/mesh_ratios.py PORT.json REFERENCE.json

PORT.json is what ``python -m repro_torch.launch.dryrun --mesh both
--device meta --out PORT.json`` writes, REFERENCE.json what ``python -m
repro.launch.dryrun --mesh both --out REFERENCE.json`` writes (jax, fake
CPU devices). Prints a markdown table with a row per (arch x shape): for
each mesh, per-device FLOPs port / reference and collective bytes port /
reference by kind (ag all-gather, ar all-reduce, rs reduce-scatter, a2a
all-to-all, cp collective-permute; "-" where neither has any, "0/x" or
"x/0" where one side has none), and whether the argument bytes are equal;
then the count of cells and statuses. It reads records only.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

KINDS = (("ag", "all-gather"), ("ar", "all-reduce"), ("rs", "reduce-scatter"),
         ("a2a", "all-to-all"), ("cp", "collective-permute"))


def ratio(a: float, b: float) -> str:
    if not a and not b:
        return "-"
    if not b:
        return f"{a:.2g}/0"
    if not a:
        return f"0/{b:.2g}"
    return f"{a / b:.3g}"


def cell(mine: dict, want: dict) -> str:
    if mine["status"] != "ok" or want["status"] != "ok":
        return f"{mine['status']} / {want['status']}"
    coll = " ".join(
        f"{short} {ratio(mine['collectives']['bytes'].get(kind, 0.0), want['collectives']['bytes'].get(kind, 0.0))}"
        for short, kind in KINDS
        if mine["collectives"]["bytes"].get(kind) or want["collectives"]["bytes"].get(kind))
    args = ("=" if mine["memory_analysis"]["argument_size_in_bytes"]
            == want["memory_analysis"]["argument_size_in_bytes"] else "≠")
    return f"{mine['flops'] / want['flops']:.3f}; {coll}; args {args}"


def main(argv: list[str]) -> int:
    mine = {(r["arch"], r["shape"], r["mesh"]): r for r in json.loads(Path(argv[0]).read_text())}
    want = {(r["arch"], r["shape"], r["mesh"]): r for r in json.loads(Path(argv[1]).read_text())}
    print("| arch | shape | single: FLOPs; collective bytes; args | multi: the same |")
    print("| --- | --- | --- | --- |")
    rows = sorted({(a, s) for a, s, _ in want}, key=lambda k: list(want).index(k + ("single",)))
    for arch, shape in rows:
        one = [mine.get((arch, shape, m)) for m in ("single", "multi")]
        two = [want.get((arch, shape, m)) for m in ("single", "multi")]
        if all(r and r["status"] == "skipped" for r in one + two):
            continue
        print(f"| {arch} | {shape} | " + " | ".join(
            cell(a, b) if a and b else "missing" for a, b in zip(one, two)) + " |")
    for name, recs in (("port", mine), ("reference", want)):
        st = [r["status"] for r in recs.values()]
        print(f"\n{name}: {st.count('ok')} ok, {st.count('skipped')} skipped, "
              f"{st.count('error')} errors")
    skips = {k for k, r in mine.items() if r["status"] == "skipped"}
    print("same skip set:", skips == {k for k, r in want.items() if r["status"] == "skipped"})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
