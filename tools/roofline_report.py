#!/usr/bin/env python3
"""Roofline table from the port's dry-run records.

    python3 tools/roofline_report.py [PATH]    (default results/dryrun_torch.json)

Reads the JSON list that ``python -m repro_torch.launch.dryrun --out PATH``
writes and prints a markdown table with a row per (arch x shape): the
count (FLOPs, unfused bytes), MODEL_FLOPS and useful = MODEL_FLOPS /
FLOPs, the three roofline terms at one H100's rates (989 TFLOP/s bf16,
3.35 TB/s; the memory term rests on unfused bytes, so it is an upper
bound), the term that bounds the cell, the fit in the card's 80 GB
(measured peak memory for a record of a run on the card, else the step's
arguments: weights, optimizer state, batch or cache, a lower bound on
what the step holds) and the count's host seconds. A record of a run on
the card adds its batch, seconds and share of the bf16 peak. It reads
records only: no card is needed.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

DEFAULT_PATH = Path("results/dryrun_torch.json")


def held_bytes(rec: dict) -> tuple[float, str]:
    """The bytes that must fit and where they come from."""
    if "peak_memory_bytes" in rec:
        return float(rec["peak_memory_bytes"]), "peak"
    return float(rec["argument_bytes"]), "args"


def run(path=DEFAULT_PATH, report=print) -> dict:
    from repro_torch.launch.roofline import H100_HBM_BYTES

    records = json.loads(Path(path).read_text())
    recs = [r for r in records if r["status"] == "ok"]
    report("| arch | shape | FLOPs | bytes_unfused | model FLOPs | useful | compute s | "
           "memory s (<=) | collective s | bound | HBM GB | fits | count s | card run |")
    report("| --- " * 14 + "|")
    n_fit = 0
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        rt = r["roofline"]
        held, source = held_bytes(r)
        fits = held <= H100_HBM_BYTES
        n_fit += fits
        card = (f"B={r['batch']}: {r['step_s']:.4f} s, model FLOPs at "
                f"{r['roofline_share']:.2%} of peak" if "step_s" in r else "")
        report(f"| {r['arch']} | {r['shape']} | {r['flops']:.4e} | {r['bytes_unfused']:.4e} | "
               f"{rt['model_flops']:.4e} | {rt['useful_flops_ratio']:.3f} | "
               f"{rt['compute_s']:.4e} | {rt['memory_s']:.4e} | {rt['collective_s']:.1e} | "
               f"{rt['bottleneck']} | {held / 1e9:.2f} ({source}) | {'y' if fits else 'N'} | "
               f"{r['count_s']:.2f} | {card} |")
    skipped = [r for r in records if r["status"] == "skipped"]
    errors = [r for r in records if r["status"] == "error"]
    report(f"\n{len(recs)} cells ok, {len(skipped)} skipped, {len(errors)} errors; "
           f"{n_fit}/{len(recs)} fit in {H100_HBM_BYTES / 1e9:.0f} GB of HBM "
           f"(args: a lower bound; peak: measured on the card)")
    return {"ok": len(recs), "skipped": len(skipped), "errors": len(errors), "fit": n_fit}


if __name__ == "__main__":
    summary = run(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_PATH)
    sys.exit(1 if summary["errors"] else 0)
